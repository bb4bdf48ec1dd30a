"""One step traced under a counter, on any device: the port's
counterpart of the JAX package's lowered and compiled step, which the
dry run (``launch/dryrun.py``) and ``Container.lower_step`` read.

A ``Counter`` counts FLOPs through ``torch.utils.flop_counter``'s table,
bytes as each aten operator's tensor inputs read plus its outputs written
(views count 0: the port runs unfused, so this is the traffic it really
moves), the peak of live storage, and calls per kernel wrapper: a wrapper
called inside it adds its own ``cost()`` in place of whatever runs inside
it (``kernels._launch.active``). Collective bytes are counted where each
collective is called (``dist.mesh.collective``, into the mesh's
``CollectiveStats``), not parsed from HLO text.
"""

from __future__ import annotations

import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.dist.mesh import CollectiveStats
from repro_torch.kernels import _launch


@dataclass
class Cost:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collectives: CollectiveStats = field(default_factory=CollectiveStats)

    def add(self, other: "Cost", scale: int = 1) -> None:
        self.flops += other.flops * scale
        self.bytes_accessed += other.bytes_accessed * scale
        self.collectives.merge(other.collectives, scale)


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------

def _storage(t: torch.Tensor):
    return t.untyped_storage()


def _tensors(args) -> list[torch.Tensor]:
    """The tensors among an aten operator's arguments or results: each
    is a tensor, a list or tuple of them, or no tensor."""
    out = []
    for a in args:
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (tuple, list)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class Counter(TorchDispatchMode):
    """Counts one traced step, on any device: ``flops`` (FlopCounterMode's
    table), ``bytes`` (each aten operator's tensor inputs read plus its
    outputs written; views and other operators whose every output aliases
    an input count 0), ``by_op`` (the two by operator, and calls),
    ``kernel_calls`` by kernel wrapper, ``collective_calls`` (each c10d
    collective's tensor bytes and name: its traffic is the wire's, counted
    by ``CollectiveStats``, not here), and ``peak`` -- the most bytes of
    storage made inside the counter that were alive at once (what was
    alive before it, the step's arguments, is not counted).

    A kernel wrapper called inside it adds its ``cost()`` (under
    ``"kernel:<name>"`` in ``by_op``) and nothing for the aten operators
    that run inside it (``kernel``): on the CPU its plain version, on a
    card the launch's allocations, on ``meta`` the empty outputs. Where
    the model code chooses a route by device, a ``meta`` tensor inside a
    counter takes the card's (``kernels._launch.on_card_route``): a trace
    stands for the card."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.by_op: dict[str, list] = {}
        self.kernel_calls: dict[str, int] = {}
        self.collective_calls: list[tuple[int, str]] = []
        self.live = 0
        self.peak = 0
        self._registry = FlopCounterMode(display=False).flop_registry
        self._in_kernel = 0
        self._live: dict[int, int] = {}
        self._prev = None

    def __enter__(self):
        self._prev = _launch.set_active(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _launch.set_active(self._prev)
        return super().__exit__(*exc)

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(name, [0, 0, 0])
        row[0] += flops
        row[1] += nbytes
        row[2] += 1

    def _free(self, key: int, n: int) -> None:
        if self._live.pop(key, None) is not None:
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((*args, *kwargs.values()))
        outs = _tensors(out if isinstance(out, (tuple, list)) else (out,))
        in_keys = {_storage(t)._cdata for t in ins}
        fresh = False
        for t in outs:
            st = _storage(t)
            key = st._cdata
            if key in in_keys:
                continue
            fresh = True
            if key not in self._live:
                n = st.nbytes()
                self._live[key] = n
                self.live += n
                weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)
        if self._in_kernel:
            return out
        if func.namespace == "c10d":        # wire bytes: CollectiveStats
            self.collective_calls.append(
                (sum(t.nbytes for t in ins), func._overloadpacket.__name__))
            self._add(func._overloadpacket.__name__, 0, 0)
            return out
        view = func.is_view or (outs and not fresh
                                and not func._schema.is_mutable)
        nbytes = 0 if view else (sum(t.nbytes for t in ins)
                                 + sum(t.nbytes for t in outs))
        flops = 0
        fn = self._registry.get(func._overloadpacket)
        if fn is not None:
            flops = fn(*args, **kwargs, out_val=out)
        self._add(str(func._overloadpacket.__name__), flops, nbytes)
        return out

    @contextmanager
    def kernel(self, name: str, flops: float, nbytes: float):
        """One call of kernel ``name``: its ``cost()`` counted, the aten
        operators inside the block not (their storage still counts
        toward ``peak``)."""
        self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
        self._add(f"kernel:{name}", flops, nbytes)
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1


# ---------------------------------------------------------------------------
# a traced step
# ---------------------------------------------------------------------------

def _storages(tree) -> dict[int, int]:
    """Storage -> bytes of every tensor in ``tree``, each storage once."""
    return {(st := t.untyped_storage())._cdata: st.nbytes()
            for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)}


@dataclass
class Lowered:
    """One step traced under a ``Counter`` (``Container.lower_step``): the
    port's counterpart of the JAX package's lowered and compiled step, read
    through ``cost()`` and ``memory()``. ``argument_bytes`` are this
    rank's inputs (params, optimizer state, batch), ``output_bytes`` its
    outputs, ``alias_bytes`` the outputs written into an input's storage
    (an in-place update: donation)."""

    counter: Counter
    collectives: CollectiveStats
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    seconds: float

    def cost(self) -> Cost:
        return Cost(flops=float(self.counter.flops),
                    bytes_accessed=float(self.counter.bytes),
                    collectives=self.collectives)

    def memory(self) -> dict:
        """The JAX package's ``memory_analysis`` fields: temp is the peak
        of live bytes above the arguments, less the outputs' own (which
        ``resident`` adds back), so resident = arguments + that peak."""
        fresh_out = self.output_bytes - self.alias_bytes
        temp = max(0, self.counter.peak - fresh_out)
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": temp, "alias_bytes": self.alias_bytes,
                "resident_bytes": (self.argument_bytes + temp
                                   + max(0, fresh_out))}


def trace(fn, args: tuple, mesh=None,
          argument_bytes: int | None = None) -> tuple[Lowered, object]:
    """Run ``fn(*args)`` once under a ``Counter`` -> (its ``Lowered``, its
    output). The collectives it runs over ``mesh`` are counted apart from
    what the mesh counted before (and added to that after).
    ``argument_bytes`` defaults to the bytes of ``args``' storages."""
    ins = _storages(args)
    saved = None
    if mesh is not None:
        saved, mesh.stats = mesh.stats, CollectiveStats()
    t0 = time.perf_counter()
    try:
        with Counter() as counter:
            out = fn(*args)
    finally:
        stats = CollectiveStats()
        if mesh is not None:
            stats, mesh.stats = mesh.stats, saved
            saved.merge(stats)
    seconds = time.perf_counter() - t0
    outs = _storages(out)
    low = Lowered(counter, stats,
                  sum(ins.values()) if argument_bytes is None
                  else argument_bytes,
                  sum(outs.values()),
                  sum(n for k, n in outs.items() if k in ins), seconds)
    return low, out
