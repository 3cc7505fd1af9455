"""Architecture / run configuration schema (port of
``src/repro/configs/base.py``).

``ModelConfig`` keeps every field of the JAX package's, so a config reads
the same in both packages; ``torch_dtype`` takes the place of ``jdtype``.
Layer structure is two repeating pattern strings: ``mixer_pattern`` ('G'
global attention, 'L' local attention, 'M' Mamba2, 'R' RG-LRU) and
``ffn_pattern`` ('D' dense MLP, 'E' mixture of experts, 'N' none). The
encoder (whisper's, over precomputed frame embeddings) and the VLM stub
(precomputed patch embeddings over the first token positions) are
sub-configs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: Optional[int] = None
    conv_width: int = 4
    block_width: int = 4


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_frames: int = 1500


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 1024


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    activation: str = "swiglu"      # swiglu | geglu | sq_relu | gelu
    mixer_pattern: str = "G"
    ffn_pattern: str = "D"
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    logit_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    post_norms: bool = False
    embed_scale: bool = False
    qk_norm: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    vlm: Optional[VLMConfig] = None
    dtype: str = "bfloat16"
    attn_chunk: int = 2048
    attn_chunk_threshold: int = 8192  # chunked attention for S >= this
    attn_schedule: str = "scan"
    loss_chunk: int = 8192          # token chunk for the CE loss
    moe_shards: int = 1
    remat: str = "layer"            # none | layer
    remat_group: int = 1
    scan_layers: bool = True
    scan_unroll: bool = False

    @property
    def hdim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def mixer_at(self, layer: int) -> str:
        return self.mixer_pattern[layer % len(self.mixer_pattern)]

    def ffn_at(self, layer: int) -> str:
        return self.ffn_pattern[layer % len(self.ffn_pattern)]

    @property
    def pattern_period(self) -> int:
        a, b = len(self.mixer_pattern), len(self.ffn_pattern)
        return a * b // math.gcd(a, b)

    @property
    def is_subquadratic(self) -> bool:
        kinds = {self.mixer_at(i) for i in range(self.n_layers)}
        return "G" not in kinds

    def validate(self) -> None:
        assert self.n_heads % self.n_kv_heads == 0, (self.n_heads, self.n_kv_heads)
        for i in range(self.n_layers):
            if self.mixer_at(i) == "M":
                assert self.ssm is not None
            if self.mixer_at(i) == "R":
                assert self.rglru is not None
            if self.ffn_at(i) == "E":
                assert self.moe is not None
            if self.mixer_at(i) == "L":
                assert self.sliding_window is not None


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell of the assignment."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)
