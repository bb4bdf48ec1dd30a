"""Roofline analysis of the port's traced steps (the port of
``repro.launch.analysis``).

Three terms per (arch x shape x mesh), at the constants of one NVIDIA H100
SXM (NVIDIA's data sheet, dense rates, at its 700 W power limit):

  compute    = FLOPs_per_device / peak FLOP/s        (989 TFLOP/s bf16)
  memory     = bytes_per_device / HBM rate           (3.35 TB/s)
  collective = wire_bytes_per_device / wire rate     (50 GB/s)

The wire rate is one budget a device: one 400 Gb/s NDR port a card, since
a 16-way ``model`` group spans two 8-card hosts. NVLink inside a host moves
450 GB/s each way; this single term ignores it, as the JAX package's
single ``ICI_BW`` ignores the TPU's torus.

The port has no HLO. A step is traced on the Container's device --
``meta`` for the dry run, one rank of a job of fake ranks -- under
``core.trace.Counter``: FLOPs come from
``torch.utils.flop_counter.FlopCounterMode``'s table, bytes are each aten
operator's tensor inputs read plus its outputs written (views count 0:
the port runs unfused, so this is the traffic it really moves), and a
kernel wrapper adds its own ``cost()`` in place of whatever runs inside
it. Collective bytes are counted where each collective is called
(``dist.mesh.collective``, into the mesh's ``CollectiveStats``), not
parsed from HLO text: the JAX package's ``parse_collectives`` and
``_shape_bytes`` have no counterpart. The cross-pod test comes from each
group's members (pod = rank // 256). ``Cost``, the traced step's totals,
is ``core.trace``'s.

No scan correction: the port runs a Python loop over the layers, so a
trace sees every layer, and the totals come from the whole trace. The
per-stage unit probes are recorded beside them, not added again.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.trace import Cost

# ---- NVIDIA H100 SXM constants (per card; data sheet, dense) ---------------
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}  # FLOP/s
HBM_BW = 3.35e12                               # B/s
WIRE_BW = 50e9                                 # B/s a device (NDR port)
HBM_PER_CHIP = 80 * 10**9                      # 80 GB


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    """The least time the card could take for work that moves ``nbytes``
    and does ``flops`` operations on ``dtype`` inputs, in ms, and which of
    the two bounds it ("bytes" or "operations")."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    model_flops_global: float
    n_devices: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (traced flops aggregated over devices)."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """(useful work at peak) / (time the dominant term implies).

        == MFU if compute-bound with zero waste."""
        ideal = self.model_flops_global / (self.n_devices
                                           * PEAK_FLOPS["bfloat16"])
        return ideal / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "model_flops_global": self.model_flops_global,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "n_devices": self.n_devices,
        }


def roofline(cost: Cost, model_flops_global: float, n_devices: int) -> Roofline:
    return Roofline(
        compute_s=cost.flops / PEAK_FLOPS["bfloat16"],
        memory_s=cost.bytes_accessed / HBM_BW,
        collective_s=cost.collectives.wire_bytes() / WIRE_BW,
        flops_per_device=cost.flops,
        bytes_per_device=cost.bytes_accessed,
        wire_bytes_per_device=cost.collectives.wire_bytes(),
        model_flops_global=model_flops_global,
        n_devices=n_devices,
    )


def model_flops(cfg, cell, tokens_override: float | None = None) -> float:
    """6·N·D (train) / 2·N·D (prefill & decode); N = flop-participating,
    *active* params for MoE."""
    n_active = cfg.param_count(active_only=True)
    if not cfg.tie_embeddings:
        n_active -= cfg.vocab_size * cfg.d_model   # lookup table does no flops
    tokens = tokens_override
    if tokens is None:
        tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n_active * tokens


