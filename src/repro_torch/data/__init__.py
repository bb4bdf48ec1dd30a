from repro_torch.data.pipeline import DataConfig, SyntheticLM, batches

__all__ = ["DataConfig", "SyntheticLM", "batches"]
