"""gemma-7b [dense]: 28L d_model=3072 16H (kv=16, head_dim=256) d_ff=24576,
vocab=256000 — GeGLU [arXiv:2403.08295] (port of
``src/repro/configs/gemma_7b.py``)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
        d_ff=24576, vocab=256000, activation="geglu",
        mixer_pattern="G", ffn_pattern="D",
        embed_scale=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab=256, activation="geglu",
        mixer_pattern="G", ffn_pattern="D",
        embed_scale=True, dtype="float32",
    )
