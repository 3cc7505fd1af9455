"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1, head_dim=256)
d_ff=12288, vocab=256000 — RG-LRU + local attention, pattern (R,R,L)
[arXiv:2402.19427] (port of ``src/repro/configs/recurrentgemma_9b.py``)."""
from repro_torch.configs.base import ModelConfig, RGLRUConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b", family="hybrid",
        n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
        d_ff=12288, vocab=256000, activation="geglu",
        mixer_pattern="RRL", ffn_pattern="D", sliding_window=2048,
        rglru=RGLRUConfig(lru_width=4096),
        embed_scale=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=256, activation="geglu",
        mixer_pattern="RRL", ffn_pattern="D", sliding_window=16,
        rglru=RGLRUConfig(lru_width=64),
        embed_scale=True, dtype="float32",
    )
