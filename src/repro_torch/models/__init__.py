from repro_torch.models.config import ModelConfig, ShapeCell, SHAPE_CELLS
from repro_torch.models.transformer import Model, build_stages
