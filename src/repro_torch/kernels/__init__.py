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
