"""Architecture registry of the port (counterpart of
``src/repro/configs/``). Only the dense ``tinyllama-1.1b`` is registered:
the other nine architectures of the JAX package wait for their model
families (MoE, SSM, RG-LRU, encoder, VLM; ``ROADMAP.md`` queue 1)."""
from repro_torch.configs import tinyllama_1p1b
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_shape

ARCHS = {
    "tinyllama-1.1b": tinyllama_1p1b,
}


def get_config(name: str) -> ModelConfig:
    cfg = ARCHS[name].config()
    cfg.validate()
    return cfg


def get_smoke(name: str) -> ModelConfig:
    cfg = ARCHS[name].smoke()
    cfg.validate()
    return cfg


__all__ = [
    "ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
    "get_smoke", "get_shape",
]
