"""Attention token mixer: GQA/MQA, RoPE, sliding window, softcaps (port of
``src/repro/models/attention.py``, its full-attention path).

``full_attention`` is written as the reference writes it: the logits
product in float32 (the JAX package's ``preferred_element_type``; a
bf16 product is exact in float32, so casting the operands first is the
same arithmetic), then the scale, the softcap and the -1e30 bias; the
softmax in float32, cast back to the activation dtype, then probs . V.
``F.scaled_dot_product_attention`` is not used: its arithmetic differs
from the reference's and the backend it picks is not pinned.

The streaming ``chunked_attention`` (taken at S >= attn_chunk_threshold),
``decode_attention`` and ``cache_update`` wait for the LLM engine's port
(``ROADMAP.md`` queue 1, item 8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import rope, softcap


class AttnParams(NamedTuple):
    wq: torch.Tensor   # (D, H*Dh)
    wk: torch.Tensor   # (D, Kv*Dh)
    wv: torch.Tensor   # (D, Kv*Dh)
    wo: torch.Tensor   # (H*Dh, D)


def _split_heads(q, k, v, n_kv: int):
    """q: (B,S,H,Dh) -> (B, Kv, G, S, Dh); k/v: (B,S,Kv,Dh) -> (B,Kv,S,Dh)."""
    B, S, H, Dh = q.shape
    G = H // n_kv
    q = q.reshape(B, S, n_kv, G, Dh).permute(0, 2, 3, 1, 4)
    k = k.permute(0, 2, 1, 3)
    v = v.permute(0, 2, 1, 3)
    return q, k, v


def _sdpa_block(q, k, bias, cap: Optional[float], scale: float):
    """q (B,Kv,G,Sq,Dh), k (B,Kv,Skv,Dh), bias broadcastable (Sq,Skv):
    float32 logits (the caller does the softmax)."""
    logits = torch.matmul(q.float(), k.float().unsqueeze(2).transpose(-1, -2))
    logits = logits * scale
    logits = softcap(logits, cap)
    return logits + bias


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    n_kv: int,
    causal: bool = True,
    window: Optional[int] = None,
    cap: Optional[float] = None,
) -> torch.Tensor:
    B, S, H, Dh = q.shape
    S_kv = k.shape[1]
    scale = Dh ** -0.5
    qh, kh, vh = _split_heads(q, k, v, n_kv)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S_kv, device=q.device)[None, :]
    mask = torch.ones((S, S_kv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    bias = torch.where(mask, 0.0, -1e30).to(torch.float32)
    logits = _sdpa_block(qh, kh, bias, cap, scale)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(probs, vh.unsqueeze(2))
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh)


def attn_forward(
    p: AttnParams,
    x: torch.Tensor,                 # (B, S, D)
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    causal: bool = True,
    window: Optional[int] = None,
    cap: Optional[float] = None,
    positions: Optional[torch.Tensor] = None,
    use_rope: bool = True,
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    chunked: bool = False,
    q_chunk: int = 2048,
    kv_chunk: int = 2048,
    schedule: str = "scan",
) -> torch.Tensor:
    if chunked:
        raise NotImplementedError(
            "chunked_attention (S >= attn_chunk_threshold) waits for the LLM "
            "engine's port (ROADMAP.md queue 1, item 8)")
    B, S, D = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = (x @ p.wq).reshape(B, S, n_heads, head_dim)
    if kv_override is None:
        k = (x @ p.wk).reshape(B, S, n_kv, head_dim)
        v = (x @ p.wv).reshape(B, S, n_kv, head_dim)
        if use_rope:
            q = rope(q, positions, rope_theta)
            k = rope(k, positions, rope_theta)
    else:
        k, v = kv_override
        if use_rope:
            q = rope(q, positions, rope_theta)
    o = full_attention(q, k, v, n_kv=n_kv, causal=causal, window=window, cap=cap)
    return o.reshape(B, S, n_heads * head_dim) @ p.wo
