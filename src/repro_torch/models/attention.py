"""Attention token mixer: GQA/MQA, RoPE, sliding window, softcaps (port of
``src/repro/models/attention.py``: its full-attention and decode paths).

``full_attention`` is written as the reference writes it: the logits
product in float32 (the JAX package's ``preferred_element_type``; a
bf16 product is exact in float32, so casting the operands first is the
same arithmetic), then the scale, the softcap and the -1e30 bias; the
softmax in float32, cast back to the activation dtype, then probs . V.
``F.scaled_dot_product_attention`` is not used: its arithmetic differs
from the reference's and the backend it picks is not pinned.

``decode_attention`` is one query token against a ``KVCache`` with the
same arithmetic: entries past ``pos`` are masked, and a rolling cache
(a sliding-window layer, ``S_cache == window``) has every slot valid once
``pos >= S_cache``. ``cache_update`` writes a step's k/v at
``pos % S_cache`` in place into the preallocated cache and returns it
(the JAX package returns a new array; copying every layer's cache each
token would move the whole cache). The reference's ``attn_forward`` has
no counterpart: the model's mixer (``transformer._apply_mixer``) composes
``project_qkv``, ``full_attention`` or ``decode_attention``, and ``wo``,
and keeps the prefill's k/v. The streaming ``chunked_attention`` (taken
at S >= attn_chunk_threshold) waits for its port (``ROADMAP.md`` queue
1, item 8b); the mixer raises ``chunked_unported`` in its place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.common import rope, softcap


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_cache, Kv, Dh)
    v: torch.Tensor  # (B, S_cache, Kv, Dh)
    # rolling caches (sliding-window layers): S_cache == window and writes
    # wrap modulo the window.


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


def chunked_unported() -> NotImplementedError:
    return NotImplementedError(
        "chunked_attention (S >= attn_chunk_threshold) waits for its port "
        "(ROADMAP.md queue 1, item 8b)")


def decode_attention(
    q1: torch.Tensor,           # (B, 1, H, Dh)
    cache: KVCache,
    pos: int,                   # current position (tokens already cached)
    *,
    n_kv: int,
    window: Optional[int] = None,
    cap: Optional[float] = None,
) -> torch.Tensor:
    """One-token attention against the cache (already holding this step's
    k/v at index pos % S_cache). Entries beyond pos are masked."""
    B, S_cache, Kv, Dh = cache.k.shape
    H = q1.shape[2]
    G = H // n_kv
    scale = Dh ** -0.5
    qh = q1.reshape(B, 1, n_kv, G, Dh).permute(0, 2, 3, 1, 4)  # (B,Kv,G,1,Dh)
    kh = cache.k.permute(0, 2, 1, 3)
    vh = cache.v.permute(0, 2, 1, 3)
    idx = torch.arange(S_cache, device=q1.device)
    valid = idx <= pos
    if window is not None:
        # rolling cache: all S_cache == window slots valid once warm
        valid = valid | (pos >= S_cache)
    bias = torch.where(valid, 0.0, -1e30).to(torch.float32)[None, :]
    logits = _sdpa_block(qh, kh, bias, cap, scale)  # (B,Kv,G,1,S)
    probs = torch.softmax(logits, dim=-1).to(q1.dtype)
    out = torch.matmul(probs, vh.unsqueeze(2))
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, Dh)


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int) -> KVCache:
    """Write this step's k/v (B,1,Kv,Dh) at pos (modulo a rolling window),
    in place, and return the cache."""
    slot = pos % cache.k.shape[1]
    cache.k[:, slot:slot + 1] = k_new
    cache.v[:, slot:slot + 1] = v_new
    return cache


def project_qkv(p: AttnParams, x: torch.Tensor, *, n_heads: int, n_kv: int,
                head_dim: int, rope_theta: float, positions: torch.Tensor):
    """q, k and v of ``x`` (B, S, D), RoPE at ``positions`` on q and k."""
    B, S, _ = x.shape
    q = (x @ p.wq).reshape(B, S, n_heads, head_dim)
    k = (x @ p.wk).reshape(B, S, n_kv, head_dim)
    v = (x @ p.wv).reshape(B, S, n_kv, head_dim)
    return (rope(q, positions, rope_theta), rope(k, positions, rope_theta), v)

