"""Elastic restore: a checkpoint placed on another device (the port of
``repro.checkpoint.elastic``).

CheckpointStore is layout-agnostic (whole tensors by tree path), so moving
a run to another platform is: restore -> cast to the template's dtypes ->
place on the target device. On one card the JAX package's tree of
``NamedSharding``s is one ``torch.device``; sharded targets come with
ROADMAP.md Queue 1 item 11.

Node-failure story, as in the JAX package:
  1. detect failure (missed heartbeat / collective timeout);
  2. relaunch the job on the surviving platform;
  3. ``reshard_restore`` the last published checkpoint onto it;
  4. the deterministic data pipeline (data/pipeline.py) replays from the
     restored step, so no data is skipped or double-counted.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.store import CheckpointStore, _unflatten, _flatten


def reshard_restore(store: CheckpointStore, template,
                    device: torch.device | str, step: int | None = None):
    """Restore ``step`` (default: the latest) into ``template``'s structure,
    each leaf cast to the template leaf's dtype and placed on ``device``.

    ``template`` carries shapes and dtypes: tensors, or meta tensors from
    ``Container.abstract_params`` / ``abstract_opt_state``."""
    host = dict(_flatten(store.restore(template, step)))
    dtypes = dict(_flatten(template))
    return _unflatten(template, {
        path: t.to(device=device, dtype=dtypes[path].dtype)
        for path, t in host.items()})
