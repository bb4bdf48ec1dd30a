"""Deterministic, restartable data pipeline (a copy of
``repro.data.pipeline``: numpy only, so both packages draw the same
batches from the same seed; the train step moves them to the device).

Every rank of a multi-process job draws the same global batch and keeps
the rows of its data replica (``rank_rows``), so the global batch does
not depend on the world size: the JAX package's ``P(batch_axes)``
in-spec.

Paper §4.1 runs data I/O through *host mounts* into the container; here the
"mount" is an array store on the host filesystem read into the container's
overlay. Two sources:

* ``SyntheticLM`` -- deterministic Zipf-ish token streams keyed by
  (seed, step, shard): restart-exact (resuming at step k regenerates the
  identical batch k), which is what makes checkpoint/restart bitwise
  reproducible without persisting a dataloader state blob.
* ``MemmapLM``   -- token shards memory-mapped from a host directory
  (one .npy per host, the "one big file per node" shape the paper's Fig. 4
  argues for -- many tiny files is exactly the import problem).

Batches are next-token-prediction: tokens[t] predicts labels[t] =
stream[t+1].
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_len: int = 0
    d_model: int = 0          # for frontend embedding stubs


class SyntheticLM:
    """Zipf-distributed token stream; fully deterministic in (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        tok_len = cfg.seq_len - cfg.frontend_len
        key = int.from_bytes(
            hashlib.sha256(f"{cfg.seed}:{step}".encode()).digest()[:8], "little"
        )
        rng = np.random.default_rng(key)
        # zipf-ish: sample ranks, clip to vocab
        z = rng.zipf(1.2, size=(cfg.global_batch, tok_len + 1))
        stream = np.minimum(z - 1, cfg.vocab_size - 1).astype(np.int32)
        out = {
            "tokens": stream[:, :-1],
            "labels": stream[:, 1:],
        }
        if cfg.frontend_len:
            out["frontend_embeds"] = rng.standard_normal(
                (cfg.global_batch, cfg.frontend_len, cfg.d_model)
            ).astype(np.float32) * 0.02
        return out


class MemmapLM:
    """Token shards mmapped from ``root/shard-*.npy`` (host-mount analog)."""

    def __init__(self, cfg: DataConfig, root: str | Path):
        self.cfg = cfg
        self.shards = sorted(Path(root).glob("shard-*.npy"))
        if not self.shards:
            raise FileNotFoundError(f"no shard-*.npy under {root}")
        self._data = np.concatenate([np.load(p, mmap_mode="r")[:]
                                     for p in self.shards])

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        need = cfg.global_batch * (cfg.seq_len + 1)
        n = self._data.shape[0]
        start = (step * need) % max(1, n - need)
        flat = np.asarray(self._data[start:start + need], dtype=np.int32)
        flat = flat.reshape(cfg.global_batch, cfg.seq_len + 1)
        return {"tokens": flat[:, :-1], "labels": flat[:, 1:]}

    @staticmethod
    def write_shards(root: str | Path, tokens: np.ndarray, n_shards: int = 4):
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        for i, part in enumerate(np.array_split(tokens.astype(np.int32), n_shards)):
            np.save(root / f"shard-{i:05d}.npy", part)


def batches(source, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield source.batch(step)
        step += 1


def rank_rows(batch: dict, index: int, replicas: int) -> dict:
    """Rows ``[index * B / replicas, (index + 1) * B / replicas)`` of every
    array of a global batch of ``B`` rows: ``index`` is a rank's
    coordinate over the mesh's batch axes (row-major) and ``replicas``
    their size, so the ranks of one data replica (its model axis) take the
    same block."""
    if replicas == 1:
        return batch
    rows = {len(v) for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % replicas:
        raise ValueError(f"a global batch of {sorted(rows)} rows does not "
                         f"split over {replicas} ranks")
    b = next(iter(rows)) // replicas
    return {k: v[index * b:(index + 1) * b] for k, v in batch.items()}
