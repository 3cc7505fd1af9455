"""mixtral-8x22b [moe]: 56L d_model=6144 48H (GQA kv=8) expert_ff=16384,
vocab=32768, 8 experts top-2, SWA window 4096 [arXiv:2401.04088] (port of
``src/repro/configs/mixtral_8x22b.py``)."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
        vocab=32768, activation="swiglu",
        mixer_pattern="L", ffn_pattern="E", sliding_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
        tie_embeddings=False, rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=256, activation="swiglu",
        mixer_pattern="L", ffn_pattern="E", sliding_window=16,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
        tie_embeddings=False, dtype="float32",
    )
