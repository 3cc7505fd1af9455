"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) expert_ff=2048,
vocab=163840, 384 experts top-8 — trillion-param MoE (paper-table) (port
of ``src/repro/configs/kimi_k2.py``). One layer's expert banks hold 16.9 G
parameters, more than one H100 holds with their momentum: the port runs
this architecture at its smoke size."""
from repro_torch.configs.base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_ff=2048,
        vocab=163840, activation="swiglu",
        mixer_pattern="G", ffn_pattern="E",
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                      capacity_factor=1.0),
        tie_embeddings=False, rope_theta=5e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="kimi-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=32,
        vocab=256, activation="swiglu",
        mixer_pattern="G", ffn_pattern="E",
        moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=32, capacity_factor=1.0),
        tie_embeddings=False, dtype="float32",
    )
