"""Hand-written CUDA kernels for Hopper, one package per TPU kernel ported.

Each package holds ``ref.py`` (the plain PyTorch version) and ``ops.py``
(the public wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel built from ``repro_torch/csrc`` or raises)."""


def launch_counts() -> dict[str, int]:
    """Kernel name -> its wrapper's ``launches`` counter."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.matmul import ops as mm_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"paged_attention": pa_ops.launches,
            "flash_attention_fwd": fa_ops.launches, "ssd": ssd_ops.launches,
            "rglru_scan": rg_ops.launches, "matmul": mm_ops.launches}


def bwd_launch_counts() -> dict[str, int]:
    """Backward kernel name -> its wrapper's ``bwd_launches`` counter: K2's
    backward kernels (the flash-attention Function's backward on a card,
    one a call), K4's reverse scan (the RG-LRU Function's) and K5's
    backward kernels (the SSD Function's, one a call); the forward counts
    stay apart."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"flash_attention_bwd": fa_ops.bwd_launches,
            "rglru_scan_bwd": rg_ops.bwd_launches,
            "ssd_bwd": ssd_ops.bwd_launches}
