"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H MHA, d_ff=2048,
vocab=51865. Conv/mel frontend is a STUB (precomputed frame embeddings).
Adaptation note (DESIGN.md): RoPE replaces whisper's learned positions
(port of ``src/repro/configs/whisper_base.py``)."""
from repro_torch.configs.base import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="audio",
        n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
        vocab=51865, activation="gelu",
        mixer_pattern="G", ffn_pattern="D",
        encoder=EncoderConfig(n_layers=6, n_frames=1500),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=256, activation="gelu",
        mixer_pattern="G", ffn_pattern="D",
        encoder=EncoderConfig(n_layers=2, n_frames=16),
        dtype="float32",
    )
