"""Architecture registry of the port (counterpart of
``src/repro/configs/``): the ten architectures of the JAX package, dense,
MoE, SSM (``mamba2-2.7b``), hybrid (``recurrentgemma-9b``), audio
(``whisper-base``) and VLM (``pixtral-12b``), and the paper's own QR
problems (``paper_qr``: ``PRODUCTION`` and ``SMOKE``), the dry run's
``caqr`` cell."""
from repro_torch.configs import (
    gemma2_2b,
    gemma_7b,
    kimi_k2,
    mamba2_2p7b,
    mixtral_8x22b,
    nemotron_4_340b,
    paper_qr,
    pixtral_12b,
    recurrentgemma_9b,
    tinyllama_1p1b,
    whisper_base,
)
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, get_shape

ARCHS = {
    "mamba2-2.7b": mamba2_2p7b,
    "whisper-base": whisper_base,
    "mixtral-8x22b": mixtral_8x22b,
    "kimi-k2-1t-a32b": kimi_k2,
    "gemma2-2b": gemma2_2b,
    "tinyllama-1.1b": tinyllama_1p1b,
    "gemma-7b": gemma_7b,
    "nemotron-4-340b": nemotron_4_340b,
    "pixtral-12b": pixtral_12b,
    "recurrentgemma-9b": recurrentgemma_9b,
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
    "get_smoke", "get_shape", "paper_qr",
]
