from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.checkpoint.elastic import reshard_restore
from repro_torch.checkpoint.straggler import StragglerMonitor

__all__ = ["CheckpointStore", "reshard_restore", "StragglerMonitor"]
