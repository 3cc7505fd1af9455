"""Data of the port (counterpart of ``src/repro/data/``): the
deterministic synthetic pipeline."""
from repro_torch.data.pipeline import DataConfig, Pipeline, make_batch

__all__ = ["DataConfig", "Pipeline", "make_batch"]
