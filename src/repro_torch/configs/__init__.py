"""Architecture registry of the port (counterpart of
``src/repro/configs/``): the dense ``tinyllama-1.1b``, ``gemma-7b``,
``gemma2-2b`` and ``nemotron-4-340b`` and the MoE ``mixtral-8x22b`` and
``kimi-k2-1t-a32b``. The other four architectures of the JAX package wait
for their model families (SSM, RG-LRU, encoder, VLM; ``ROADMAP.md`` queue
1, item 10)."""
from repro_torch.configs import (
    gemma2_2b,
    gemma_7b,
    kimi_k2,
    mixtral_8x22b,
    nemotron_4_340b,
    tinyllama_1p1b,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_shape

ARCHS = {
    "mixtral-8x22b": mixtral_8x22b,
    "kimi-k2-1t-a32b": kimi_k2,
    "gemma2-2b": gemma2_2b,
    "tinyllama-1.1b": tinyllama_1p1b,
    "gemma-7b": gemma_7b,
    "nemotron-4-340b": nemotron_4_340b,
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
