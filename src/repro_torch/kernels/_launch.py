"""What every kernel wrapper shares: dtype codes, the current stream, and
turning a launcher's return code into an exception."""

from __future__ import annotations

import torch

# the dtype argument of every extern "C" launcher in repro_torch/csrc
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    try:
        return DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(f"{what}: dtype {t.dtype} not supported by the kernel "
                        f"(expected one of {sorted(map(str, DTYPE_CODES))})"
                        ) from None


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def stream_ptr(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(rc: int, lib, error_fn: str, kernel: str) -> None:
    if rc != 0:
        msg = getattr(lib, error_fn)(rc)
        raise RuntimeError(f"{kernel}: CUDA error {rc} "
                           f"({msg.decode() if msg else 'unknown'})")
