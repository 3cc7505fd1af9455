"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8, head_dim=128)
d_ff=14336, vocab=131072 — pixtral-ViT frontend is a STUB (precomputed
patch embeddings) + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409]
(port of ``src/repro/configs/pixtral_12b.py``)."""
from repro_torch.configs.base import ModelConfig, VLMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="pixtral-12b", family="vlm",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab=131072, activation="swiglu",
        mixer_pattern="G", ffn_pattern="D",
        vlm=VLMConfig(n_patches=1024),
        tie_embeddings=False, rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="pixtral-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, activation="swiglu",
        mixer_pattern="G", ffn_pattern="D",
        vlm=VLMConfig(n_patches=8),
        tie_embeddings=False, dtype="float32",
    )
