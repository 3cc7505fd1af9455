"""tinyllama-1.1b [dense]: 22L d_model=2048 32H (GQA kv=4) d_ff=5632,
vocab=32000 — llama2-arch small [arXiv:2401.02385] (port of
``src/repro/configs/tinyllama_1p1b.py``)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=5632,
        vocab=32000, activation="swiglu",
        mixer_pattern="G", ffn_pattern="D",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128,
        vocab=256, activation="swiglu",
        mixer_pattern="G", ffn_pattern="D",
        tie_embeddings=False, dtype="float32",
    )
