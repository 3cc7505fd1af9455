"""nemotron-4-340b [dense]: 96L d_model=18432 96H (GQA kv=8) d_ff=73728,
vocab=256000 — squared-ReLU MLP [arXiv:2402.16819] (port of
``src/repro/configs/nemotron_4_340b.py``). It does not fit on one H100:
the port runs it at its smoke size."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", family="dense",
        n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, d_ff=73728,
        vocab=256000, activation="sq_relu",
        mixer_pattern="G", ffn_pattern="D",
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=256,
        vocab=256, activation="sq_relu",
        mixer_pattern="G", ffn_pattern="D",
        tie_embeddings=False, dtype="float32",
    )
