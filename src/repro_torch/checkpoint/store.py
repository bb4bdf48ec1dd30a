"""Content-addressed checkpoint store with async save and atomic publish
(the port of ``repro.checkpoint.store``; same layout on disk, so a
checkpoint moves between the packages).

* every tensor is stored once under ``blobs/<sha256 of its bytes>``:
  consecutive checkpoints share unchanged tensors;
* a checkpoint is a JSON manifest mapping tree paths -> (blob, shape,
  dtype), published atomically via rename;
* saves run on a background thread (``wait()`` joins).

Tree paths are JAX ``keystr`` strings (``['stage0']['b0']['attn']['wq']``):
dict keys in sorted order, ``None`` subtrees hold no leaf. A blob is an
``.npy`` file of the tensor's bytes in C order. bfloat16, which numpy has
no type for, is stored as its raw 16-bit little-endian words with the
descriptor ``<V2`` -- what ``np.save`` writes for the JAX package's
``ml_dtypes`` bfloat16 arrays -- and the manifest's ``dtype`` says
``bfloat16``; restore decodes by that name.

Differences from the JAX package, both about one host's memory and disk:

* ``save`` joins the previous write BEFORE it copies the new tree to the
  host (the JAX package copies first), so one host copy is alive at a
  time: llama3.2-3b's float32 params, m and v are 38.5 GB;
* ``keep > 0`` drops old checkpoints before a write so that at most
  ``keep`` remain once it is published (the one being written counts, so
  with ``keep=1`` a crash during the write leaves none). The default, 0,
  keeps every checkpoint, as the JAX package does.

A store given the ``mesh`` of a multi-process job saves with its
``shardings``: each leaf a rank holds only part of (model-axis shards,
ZeRO-1 parts, PowerSGD rows; split on any number of dims) is gathered
into the whole tensor first, then rank 0 alone writes, and every rank
waits for it. So a checkpoint from N ranks
is the same file set as one from a single process, and it still moves
between the packages.

Restore returns whole CPU tensors; ``checkpoint.elastic.reshard_restore``
casts them, takes the part the target mesh gives this rank and places it
on a device.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

BF16_WORD = np.dtype("V2")      # a bfloat16 value's raw 16 bits
WRITERS = 8                     # threads hashing and writing blobs


def _flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(keystr path, leaf) in JAX's flatten order: dict keys sorted, list
    and tuple items by index, ``None`` skipped."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (C-ordered numpy array of its bytes, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        # a copy: the caller may go on updating ``leaf`` in place
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_WORD), "bfloat16"
        arr = t.numpy()
    else:
        # NOTE: np.ascontiguousarray promotes 0-d -> 1-d; keep the rank
        arr = np.asarray(leaf, order="C")
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded blob (a fresh array, so no copy) as a tensor."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype, copy=False))


def _digest(arr: np.ndarray) -> str:
    return hashlib.sha256(arr.reshape(-1).view(np.uint8)).hexdigest()


class CheckpointStore:
    def __init__(self, root: str | os.PathLike, keep: int = 0, mesh=None):
        self.root = Path(root)
        self.mesh = mesh
        if self._writer:
            (self.root / "blobs").mkdir(parents=True, exist_ok=True)
            (self.root / "manifests").mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_stats: dict | None = None

    # -- save --------------------------------------------------------------
    @property
    def _writer(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def save(self, step: int, tree, blocking: bool = False,
             shardings=None) -> None:
        """Join the previous write, snapshot to the host synchronously,
        write blobs async. With a mesh of several ranks, collective:
        ``shardings`` (a NamedSharding tree like ``tree``) names the
        leaves to gather whole; rank 0 writes; every rank returns once it
        has its snapshot (with ``blocking``, once it is published)."""
        if shardings is not None and self.mesh is not None \
                and self.mesh.size > 1:
            from repro_torch.core.abi import all_gather
            shs = dict(_flatten(shardings))
            tree = _unflatten(tree, {
                path: all_gather(leaf, shs[path], "checkpoint")
                if shs[path].split() else leaf
                for path, leaf in _flatten(tree)})
        if self._writer:
            self.wait()
            host = [(path, *_to_host(leaf)) for path, leaf in _flatten(tree)]
            if blocking:
                self._write(step, host)
            else:
                self._thread = threading.Thread(
                    target=self._write, args=(step, host), daemon=True)
                self._thread.start()
        if self.mesh is not None:
            self.mesh.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write_blob(self, digest: str, arr: np.ndarray) -> None:
        blob = self.root / "blobs" / digest
        tmp = blob.with_suffix(".tmp")
        with open(tmp, "wb") as f:
            np.save(f, arr, allow_pickle=False)
        os.replace(tmp, blob)

    def _write(self, step: int, host: list) -> None:
        t0 = time.perf_counter()
        if self.keep:
            older = [s for s in self.steps() if s != step]
            self._drop(older[:max(0, len(older) - (self.keep - 1))])
        arrays = [arr for _, arr, _ in host]
        with ThreadPoolExecutor(WRITERS) as pool:
            digests = list(pool.map(_digest, arrays))
            new: dict[str, np.ndarray] = {}
            for digest, arr in zip(digests, arrays):
                if digest not in new and not (
                        self.root / "blobs" / digest).exists():
                    new[digest] = arr
            list(pool.map(self._write_blob, new, new.values()))
        manifest: dict[str, Any] = {"step": step, "tensors": {}}
        for (path, arr, dtype), digest in zip(host, digests):
            manifest["tensors"][path] = {
                "blob": digest,
                "shape": list(arr.shape),
                "dtype": dtype,
            }
        mpath = self.root / "manifests" / f"step-{step:010d}.json"
        tmp = mpath.with_suffix(".tmp")
        tmp.write_text(json.dumps(manifest))
        os.replace(tmp, mpath)          # atomic publish
        latest = self.root / "LATEST"
        ltmp = latest.with_suffix(".tmp")
        ltmp.write_text(mpath.name)
        os.replace(ltmp, latest)
        self.last_stats = {
            "step": step, "new_blobs": len(new),
            "reused_blobs": len(host) - len(new),
            "new_bytes": sum(a.nbytes for a in new.values()),
            "seconds": time.perf_counter() - t0,
        }

    # -- restore --------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(
            int(p.stem.split("-")[1])
            for p in (self.root / "manifests").glob("step-*.json"))

    def latest_step(self) -> int | None:
        latest = self.root / "LATEST"
        if not latest.exists():
            return None
        return int(latest.read_text().strip().split("-")[1].split(".")[0])

    def restore(self, template, step: int | None = None):
        """Load into the structure of ``template`` (leaves with a
        ``shape``: tensors, meta tensors, arrays) as CPU tensors."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.root}")
        manifest = json.loads(
            (self.root / "manifests" / f"step-{step:010d}.json").read_text())
        tensors = manifest["tensors"]
        out = {}
        for path, leaf in _flatten(template):
            if path not in tensors:
                raise KeyError(f"checkpoint step {step} missing tensor {path}")
            meta = tensors[path]
            arr = np.load(self.root / "blobs" / meta["blob"],
                          allow_pickle=False)
            arr = arr.reshape(tuple(meta["shape"]))
            want = tuple(getattr(leaf, "shape", ()))
            if want != tuple(arr.shape):
                raise ValueError(
                    f"{path}: checkpoint shape {arr.shape} != template {want}")
            out[path] = _from_host(arr, meta["dtype"])
        return _unflatten(template, out)

    def gc(self, keep_last: int = 3) -> int:
        """Drop old manifests + unreferenced blobs; returns blobs removed."""
        steps = self.steps()
        return self._drop(steps[:-keep_last] if keep_last else steps)

    def _drop(self, steps: list[int]) -> int:
        for s in steps:
            (self.root / "manifests" / f"step-{s:010d}.json").unlink(
                missing_ok=True)
        live: set[str] = set()
        for p in (self.root / "manifests").glob("step-*.json"):
            m = json.loads(p.read_text())
            live.update(t["blob"] for t in m["tensors"].values())
        removed = 0
        for blob in (self.root / "blobs").iterdir():
            if blob.name not in live:
                blob.unlink()
                removed += 1
        return removed
