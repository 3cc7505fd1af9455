"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free SSD, vocab=50280,
ssm_state=128 [arXiv:2405.21060] (port of
``src/repro/configs/mamba2_2p7b.py``)."""
from repro_torch.configs.base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=50280, activation="silu",
        mixer_pattern="M", ffn_pattern="N",
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1, chunk=256),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
        vocab=256, activation="silu",
        mixer_pattern="M", ffn_pattern="N",
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1, chunk=8),
        dtype="float32",
    )
