"""What every kernel wrapper shares: dtype codes, the current stream, the
card's SM count, turning a launcher's return code into an exception, and
the counter of a traced step (``core.trace.Counter``) that a wrapper
reports its work to."""

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


_sm_counts: dict[int, int] = {}


def device_index(device: torch.device) -> int:
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def device_sms(device: torch.device) -> int:
    """The SMs of the card ``device`` names (looked up once a card)."""
    idx = device_index(device)
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _sm_counts[idx]


def raise_on_error(rc: int, lib, error_fn: str, kernel: str) -> None:
    if rc != 0:
        msg = getattr(lib, error_fn)(rc)
        raise RuntimeError(f"{kernel}: CUDA error {rc} "
                           f"({msg.decode() if msg else 'unknown'})")


# the counter entered last (``core.trace.Counter``): process-wide, as
# torch's dispatch-mode stack is
_active = None


def active():
    """The counter entered last and not yet left (``None`` outside one):
    the one check a kernel wrapper makes on each call. A wrapper inside
    one adds its ``cost()`` through ``counter.kernel`` and, on ``meta``
    tensors, returns empty outputs of the kernel's shapes."""
    return _active


def set_active(counter):
    """Make ``counter`` (or ``None``) the active one; returns the one it
    replaces."""
    global _active
    prev, _active = _active, counter
    return prev


def on_card_route(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's route where the model code chooses
    one by device: a CUDA tensor, or a ``meta`` tensor inside a counter
    (a traced step stands for the card)."""
    return t.is_cuda or (t.is_meta and _active is not None)
