"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4, head_dim=256)
d_ff=9216, vocab=256000 — local/global alternating (window 4096), logit
softcap 30, attn softcap 50, sandwich norms [arXiv:2408.00118] (port of
``src/repro/configs/gemma2_2b.py``)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b", family="dense",
        n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=9216, vocab=256000, activation="geglu",
        mixer_pattern="LG", ffn_pattern="D", sliding_window=4096,
        logit_softcap=30.0, attn_softcap=50.0,
        post_norms=True, embed_scale=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, activation="geglu",
        mixer_pattern="LG", ffn_pattern="D", sliding_window=16,
        logit_softcap=30.0, attn_softcap=50.0,
        post_norms=True, embed_scale=True, dtype="float32",
    )
