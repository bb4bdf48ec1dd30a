"""Platform meshes: the MESH image layer resolved to processes and devices
(the port of ``repro.dist.mesh``).

The JAX package runs one process over a ``(pod, data, model)`` device
mesh; the port runs one process per rank (``torch.distributed``, one rank
per device), and a ``PlatformMesh`` is that mesh seen from one rank: the
axis names and sizes, this rank's coordinates, and a process group for
each set of axes a collective reduces over.

``local``    -- every rank of the job on the data axis, ``model`` = 1
                (the JAX package: every visible device on the data axis);
                its ranks run on the CUDA cards;
``cpu``      -- the same mesh on the host CPU. Only a caller that asks
                for it gets it (the CPU tests pass ``platform="cpu"``): no
                code path falls back to the CPU when CUDA is missing;
``pod``      -- one 256-chip pod: 16-way data x 16-way model;
``multipod`` -- two pods: pod x data x model = 2 x 16 x 16.

``pod`` and ``multipod`` keep the JAX package's shapes; a job of 256 (or
512) ranks resolves them, any other raises ``ValueError`` naming the
count, as ``jax.make_mesh`` fails without the devices.

Ranks are laid out row-major over the axes, so with torchrun's numbering
``make_mesh((nodes, per_node, 1), ("pod", "data", "model"))`` puts a node
on ``pod`` and its local ranks on ``data``, and ``make_mesh((d, m),
("data", "model"))`` puts ``m`` consecutive ranks in one tensor-parallel
(``model``) group. Batch ("replica") axes are ordered slow-to-fast as
("pod", "data"), which the hierarchical means of ``core/abi.py`` rely on.
``make_mesh`` creates the process group of every set of axes whose ranks
are fewer than the job's: one group per value of the other coordinates.
A mesh of one rank needs no process group and every collective over it is
the identity.

``collective`` runs one collective over a group and counts what it was
handed in the mesh's ``CollectiveStats`` under a label (the ABI's name,
``"tp"`` for the model axis, ``"metrics"`` for the step's scalars), and
as cross-pod where the group's ranks lie in more than one pod of
``POD_SIZE`` (a mesh of more than one pod). On ``meta`` tensors it neither
stages nor synchronises.

``fake_job`` makes this process rank 0 of a job of fake ranks
(``torch.distributed``'s ``fake`` backend: every collective returns at
once and moves nothing), so a Container can build one rank's parts of a
256- or 512-rank job on the ``meta`` device and trace its step: the dry
run (``launch/dryrun.py``).
"""

from __future__ import annotations

import itertools
import math
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Sequence

import torch

PLATFORMS: dict[str, dict] = {
    "local": {"axes": ("data", "model"), "shape": None, "device": "cuda"},
    "cpu": {"axes": ("data", "model"), "shape": None, "device": "cpu"},
    "pod": {"axes": ("data", "model"), "shape": (16, 16), "device": "cuda"},
    "multipod": {"axes": ("pod", "data", "model"), "shape": (2, 16, 16),
                 "device": "cuda"},
}

_RING = {"all_reduce": 2, "reduce_scatter": 1, "all_gather": 1}
POD_SIZE = 256          # ranks a pod: the JAX package's 16 x 16


@dataclass
class CollectiveStats:
    """What this rank handed to collectives: bytes by label (the ABI's
    name) and operation, counted as the JAX package's HLO analysis counts
    them (``repro/launch/analysis.py``): an all-reduce twice its tensor
    (the ring's reduce-scatter and all-gather; the JAX package doubles it
    in ``wire_bytes`` instead), a reduce-scatter its input, an all-gather
    its output; calls by operation, the bytes of collectives whose group
    spans a pod boundary, and the collectives' seconds and calls."""

    bytes: dict = field(default_factory=dict)
    seconds: float = 0.0
    calls: int = 0
    count_by_op: dict = field(default_factory=dict)
    cross_pod_bytes: int = 0

    def add(self, abi: str, op: str, nbytes: int, seconds: float,
            cross_pod: bool = False) -> None:
        by_op = self.bytes.setdefault(abi, {})
        by_op[op] = by_op.get(op, 0) + nbytes
        self.count_by_op[op] = self.count_by_op.get(op, 0) + 1
        if cross_pod:
            self.cross_pod_bytes += nbytes
        self.seconds += seconds
        self.calls += 1

    def merge(self, other: "CollectiveStats", scale: int = 1) -> None:
        """Add ``other``'s bytes, counts and cross-pod bytes ``scale``
        times (the JAX package's ``CollectiveStats.add``)."""
        for abi, by_op in other.bytes.items():
            mine = self.bytes.setdefault(abi, {})
            for op, b in by_op.items():
                mine[op] = mine.get(op, 0) + b * scale
        for op, c in other.count_by_op.items():
            self.count_by_op[op] = self.count_by_op.get(op, 0) + c * scale
        self.cross_pod_bytes += other.cross_pod_bytes * scale
        self.seconds += other.seconds * scale
        self.calls += other.calls * scale

    @property
    def bytes_by_op(self) -> dict:
        """Bytes by operation, over every label."""
        out: dict = {}
        for by_op in self.bytes.values():
            for op, b in by_op.items():
                out[op] = out.get(op, 0) + b
        return out

    def wire_bytes(self, label: str | None = None) -> int:
        """This rank's bytes on the wire (an all-reduce already counted
        twice): ``label``'s, or every label's."""
        rows = [self.bytes.get(label, {})] if label else self.bytes.values()
        return sum(n for by_op in rows for n in by_op.values())

    def reset(self) -> None:
        self.bytes, self.seconds, self.calls = {}, 0.0, 0
        self.count_by_op, self.cross_pod_bytes = {}, 0


@dataclass(eq=False)
class PlatformMesh:
    """A device mesh seen from one rank: ``axis_names`` and ``dims`` (the
    sizes), this process's ``rank`` (row-major over the axes), the
    ``backend`` of its job's process group (``None`` outside a
    torch.distributed job, and for ``launch/mesh.py``'s meshes) and the
    ``stats`` of the collectives run over it."""

    axis_names: tuple[str, ...]
    dims: tuple[int, ...]
    rank: int = 0
    backend: str | None = None
    groups: dict = field(default_factory=dict, repr=False)
    stats: CollectiveStats = field(default_factory=CollectiveStats)
    _memo: dict = field(default_factory=dict, repr=False)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def coords(self, rank: int | None = None) -> dict[str, int]:
        """The mesh coordinates of ``rank`` (default: this process)."""
        r = self.rank if rank is None else rank
        key = ("coords", r)
        if key not in self._memo:
            out = {}
            for name, n in reversed(list(zip(self.axis_names, self.dims))):
                r, out[name] = divmod(r, n)
            self._memo[key] = {a: out[a] for a in self.axis_names}
        return dict(self._memo[key])

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    def _key(self, axes: Sequence[str]) -> tuple[str, ...]:
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def group(self, axes: Sequence[str]):
        """The process group of the ranks that differ from this one only
        along ``axes``; ``None`` for the default (whole-job) group."""
        key = self._key(axes)
        if self.axes_size(key) == self.size:
            return None
        return self.groups[key]

    def members(self, axes: Sequence[str]) -> list[int]:
        """The ranks of ``group(axes)``, in the group's rank order (row-major
        over ``axes``)."""
        axes = self._key(axes)
        key = ("members", self.rank, axes)
        if key not in self._memo:
            mine = self.coords()
            self._memo[key] = [r for r in range(self.size)
                               if all(v == mine[a]
                                      for a, v in self.coords(r).items()
                                      if a not in axes)]
        return list(self._memo[key])

    def group_lists(self, axes: Sequence[str]) -> list[list[int]]:
        """Every group of ranks that differ only along ``axes`` (one for
        each value of the other coordinates), each in rank order."""
        key = self._key(axes)
        members: dict[tuple, list[int]] = {}
        for r in range(self.size):
            other = tuple(v for a, v in self.coords(r).items()
                          if a not in key)
            members.setdefault(other, []).append(r)
        return sorted(members.values())

    def crosses_pod(self, axes: Sequence[str]) -> bool:
        """Whether a group over ``axes`` holds ranks of two pods (rank //
        ``POD_SIZE``); never on a mesh of one pod or less."""
        key = ("crosses_pod", self._key(axes))
        if key not in self._memo:
            self._memo[key] = self.size > POD_SIZE and any(
                len({r // POD_SIZE for r in g}) > 1
                for g in self.group_lists(key[1]))
        return self._memo[key]

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank (the identity on one rank)."""
        if self.size == 1:
            return obj
        box = [obj]
        torch.distributed.broadcast_object_list(box, src=0)
        return box[0]

    def gather_objects(self, obj: Any) -> list:
        """Every rank's ``obj``, in rank order, on every rank."""
        if self.size == 1:
            return [obj]
        out = [None] * self.size
        torch.distributed.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.size > 1:
            torch.distributed.barrier()


def _world() -> tuple[int, int, str | None]:
    """(rank, world size, backend) of this process's torch.distributed
    job; (0, 1, None) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.get_backend()
    return 0, 1, None


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> PlatformMesh:
    """The mesh of ``shape`` over ``axes`` for this process's job, whose
    world size must equal the mesh's size. Creating the axes' process
    groups is collective: every rank calls this with the same arguments,
    in the same order."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    rank, world, backend = _world()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; "
                         f"this job has {world}")
    mesh = PlatformMesh(axes, shape, rank, backend)
    if world > 1:
        split = [a for a in axes if mesh.shape[a] > 1]
        for n in range(1, len(split) + 1):
            for key in itertools.combinations(split, n):
                if mesh.axes_size(key) == world:
                    continue
                mine, _ = torch.distributed.new_subgroups_by_enumeration(
                    mesh.group_lists(key))
                mesh.groups[key] = mine
    return mesh


@contextmanager
def fake_job(world: int):
    """This process as rank 0 of a job of ``world`` ranks on
    ``torch.distributed``'s ``fake`` backend: groups are made and every
    collective returns at once, moving nothing. The job ends (its process
    group destroyed) when the block does. For tracing one rank's step on
    the ``meta`` device (``launch/dryrun.py``); it raises inside another
    job."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist = torch.distributed
    if dist.is_initialized():
        raise RuntimeError("fake_job: this process is already in a "
                           "torch.distributed job")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_platform_mesh(platform: str = "local") -> PlatformMesh:
    """Resolve a platform name into this job's mesh."""
    spec = _platform(platform)
    if spec["shape"] is not None:
        # the JAX package's pod shapes: model is 16 in both
        return make_mesh(spec["shape"], spec["axes"])
    return make_mesh((_world()[1], 1), spec["axes"])


def batch_axes(mesh) -> tuple[str, ...]:
    """The replica (data-parallel) axes of ``mesh``, ordered slow-to-fast."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_index(mesh) -> int:
    """This rank's coordinate over the mesh's batch axes, row-major: the
    block of a batch split over them that its rows are (every rank of
    one data replica has the same)."""
    c, idx = mesh.coords(), 0
    for a in batch_axes(mesh):
        idx = idx * mesh.shape[a] + c[a]
    return idx


def _platform(platform: str) -> dict:
    try:
        return PLATFORMS[platform]
    except KeyError:
        raise ValueError(f"unknown platform {platform!r}; expected one of "
                         f"{sorted(PLATFORMS)}") from None


def local_rank() -> int:
    """This process's rank on its node (torchrun's ``LOCAL_RANK``; 0 for
    a process not started by torchrun)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def resolve_device(platform: str = "local") -> torch.device:
    """The torch device a platform name runs on: ``cuda:{LOCAL_RANK %
    cards}`` for the card platforms, so the ranks of a node share its
    cards round-robin. Raises when the platform needs CUDA and this
    process has no card."""
    kind = _platform(platform)["device"]
    if kind == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"platform {platform!r} runs on CUDA, but CUDA is not available; "
            "pass platform='cpu' to run on the host CPU")
    return torch.device(f"cuda:{local_rank() % torch.cuda.device_count()}")



def collective(mesh: PlatformMesh, label: str, op: str, out: torch.Tensor,
               inp: torch.Tensor, group, reduce: str = "sum") -> None:
    """Run ``op`` from ``inp`` into ``out`` (the same tensor for an
    all-reduce, which sums, or with ``reduce="max"`` takes the maximum)
    over ``group``, staged through host memory where a gloo group meets a
    CUDA tensor; time it and count its bytes under ``label``
    (``CollectiveStats``)."""
    dist = torch.distributed
    staged = mesh.backend == "gloo" and inp.is_cuda
    if inp.is_cuda:
        torch.cuda.synchronize(inp.device)
    t0 = time.perf_counter()
    i = inp.cpu() if staged else inp
    if op == "all_reduce":
        o = i
        dist.all_reduce(o, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[reduce],
                        group=group)
    else:
        o = torch.empty_like(out, device="cpu") if staged else out
        fn = (getattr(dist, f"{op}_single", None)      # newer torch's name
              or getattr(dist, {"reduce_scatter": "reduce_scatter_tensor",
                                "all_gather": "all_gather_into_tensor"}[op]))
        fn(o, i, group=group)
    if staged:
        out.copy_(o)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    nbytes = (out if op == "all_gather" else inp).nbytes * _RING[op]
    cross = mesh.size > POD_SIZE and mesh.crosses_pod(_group_axes(mesh,
                                                                  group))
    mesh.stats.add(label, op, nbytes, time.perf_counter() - t0, cross)


def _group_axes(mesh: PlatformMesh, group) -> tuple[str, ...]:
    """The axes whose process group ``group`` is (``None``: all)."""
    if group is None:
        return mesh.axis_names
    return next(k for k, g in mesh.groups.items() if g is group)
