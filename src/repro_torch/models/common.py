"""Shared model components (port of ``src/repro/models/common.py``):
norms, RoPE, activations, embeddings, init. The sharding annotations of
the JAX package have no counterpart on one card and are left out."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def act_fn(name: str):
    if name == "swiglu" or name == "geglu":
        raise ValueError("gated activations are handled in the MLP")
    return {"gelu": lambda x: F.gelu(x, approximate="tanh"),
            "sq_relu": lambda x: torch.square(F.relu(x)),
            "relu": F.relu, "silu": F.silu}[name]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed(tokens: torch.Tensor, table: torch.Tensor, scale: bool = False
          ) -> torch.Tensor:
    """Token embedding lookup, ``table[tokens]``. Its gradient is
    ``index_select``'s, a scatter-add that is deterministic on CUDA under
    ``torch.use_deterministic_algorithms(True)``."""
    out = table.index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, table.shape[1])
    if scale:
        out = out * torch.tensor(table.shape[1] ** 0.5, dtype=out.dtype)
    return out


def normal_init(gen: torch.Generator, shape, dtype: torch.dtype,
                scale: float = 0.02) -> torch.Tensor:
    """N(0, scale^2) draws in float32 from ``gen`` on its device, cast to
    ``dtype``."""
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)
