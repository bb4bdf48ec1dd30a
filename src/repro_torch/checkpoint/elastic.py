"""Elastic re-sharding: restore a checkpoint onto another mesh (the port
of ``repro.checkpoint.elastic``).

CheckpointStore is layout-agnostic (whole tensors by tree path), and all
shardings derive from *logical* axis rules, so moving a run from N ranks
to M (or from the card to a laptop's CPU) is: restore -> cast to the
template's dtypes -> take the part the TARGET mesh gives this rank ->
place it on this rank's device. This is the paper's portability claim
applied to *state*: the same artifact instantiates on any platform.

Node-failure story, as in the JAX package:
  1. detect failure (missed heartbeat / collective timeout);
  2. relaunch the job on the surviving platform, with fewer ranks;
  3. ``reshard_restore`` the last published checkpoint onto it;
  4. the deterministic data pipeline (data/pipeline.py) replays from the
     restored step, so no data is skipped or double-counted.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.store import CheckpointStore, _unflatten, _flatten


def reshard_restore(store: CheckpointStore, template, shardings,
                    step: int | None = None):
    """Restore ``step`` (default: the latest) into ``template``'s structure,
    each leaf cast to the template leaf's dtype.

    ``template`` carries the whole (global) shapes and dtypes: tensors, or
    meta tensors from ``Container.abstract_params`` /
    ``abstract_opt_state``. ``shardings`` is a matching tree of
    ``dist.sharding.NamedSharding`` for the TARGET mesh (each leaf becomes
    this rank's part -- on a mesh with a ``model`` axis its shard, split
    over the batch axes too for ZeRO-1 state -- on the sharding's device),
    or one device that takes every leaf whole."""
    host = dict(_flatten(store.restore(template, step)))
    dtypes = dict(_flatten(template))
    if isinstance(shardings, (str, torch.device)):
        return _unflatten(template, {
            path: t.to(device=shardings, dtype=dtypes[path].dtype)
            for path, t in host.items()})
    placed = {}
    for path, sh in _flatten(shardings):
        part = sh.local(host[path].to(dtypes[path].dtype))
        placed[path] = part.to(sh.device, copy=True).contiguous()
    return _unflatten(template, placed)
