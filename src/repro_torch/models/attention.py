"""Attention token mixer: GQA/MQA, RoPE, sliding window, softcaps (port of
``src/repro/models/attention.py``).

``full_attention`` is written as the reference writes it: the logits
product in float32 (the JAX package's ``preferred_element_type``; a
bf16 product is exact in float32, so casting the operands first is the
same arithmetic), then the scale, the softcap and the -1e30 bias; the
softmax in float32, cast back to the activation dtype, then probs . V.
``F.scaled_dot_product_attention`` is not used: its arithmetic differs
from the reference's and the backend it picks is not pinned.

``chunked_attention`` is the reference's streaming softmax over
(q_chunk, kv_chunk) blocks with its float32 running max, sum and
accumulator, -1e30 bias and softcap, in both schedules: ``"tri"`` visits
the causally visible kv chunks from the first one the window reaches;
``"scan"`` (the production schedule) visits every chunk from the first up
to the causal front, masking the ones the window excludes. The reference's
scan also computes the chunks past the causal front and keeps its old
carry there; the port skips them, which is the same carry. S must be a
multiple of both chunks, as the reference asserts.

``decode_attention`` is one query token against a ``KVCache`` with the
same arithmetic: entries past ``pos`` are masked, and a rolling cache
(a sliding-window layer, ``S_cache == window``) has every slot valid once
``pos >= S_cache``. ``cache_update`` writes a step's k/v at
``pos % S_cache`` in place into the preallocated cache and returns it
(the JAX package returns a new array; copying every layer's cache each
token would move the whole cache). ``attn_forward`` is the one path of
training, prefill, the encoder and cross-attention (``kv_override``), as
in the reference; ``return_kv`` also gives the roped k and the v, which
prefill keeps as its cache.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

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


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    n_kv: int,
    causal: bool = True,
    window: Optional[int] = None,
    cap: Optional[float] = None,
    q_chunk: int = 2048,
    kv_chunk: int = 2048,
    schedule: str = "tri",
) -> torch.Tensor:
    """Streaming-softmax attention over chunks (see the module docstring
    for the two schedules)."""
    B, S, H, Dh = q.shape
    if S % q_chunk or S % kv_chunk:
        raise ValueError(f"chunked attention: S = {S} is not a multiple of "
                         f"q_chunk {q_chunk} and kv_chunk {kv_chunk}")
    if schedule not in ("tri", "scan"):
        raise ValueError(f"unknown schedule {schedule!r}")
    scale = Dh ** -0.5
    qh, kh, vh = _split_heads(q, k, v, n_kv)  # (B,Kv,G,S,Dh), (B,Kv,S,Dh)
    n_q, n_kvc = S // q_chunk, S // kv_chunk
    G = H // n_kv
    dev = q.device
    rows = torch.arange(q_chunk, device=dev)[:, None]
    cols = torch.arange(kv_chunk, device=dev)[None, :]

    def block(carry, q_blk, q0: int, jk: int):
        m, l, acc = carry
        k0 = jk * kv_chunk
        qi, ki = q0 + rows, k0 + cols
        mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (ki <= qi)
        if window is not None:
            mask = mask & (ki > qi - window)
        bias = torch.where(mask, 0.0, -1e30).to(torch.float32)
        logits = _sdpa_block(q_blk, kh[:, :, k0:k0 + kv_chunk], bias, cap, scale)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        v_blk = vh[:, :, k0:k0 + kv_chunk].float().unsqueeze(2)
        acc_new = acc * corr[..., None] + torch.matmul(p, v_blk)
        return m_new, l_new, acc_new

    outs = []
    for iq in range(n_q):
        q0 = iq * q_chunk
        q_blk = qh[:, :, :, q0:q0 + q_chunk]
        # chunks past the causal front leave the carry as it is (the
        # reference's scan computes them and keeps the old carry)
        hi = (q0 + q_chunk + kv_chunk - 1) // kv_chunk if causal else n_kvc
        lo = 0
        if window is not None and schedule == "tri":
            # earliest query in this chunk (q0) still sees keys > q0 - window
            lo = max(0, (q0 - window + 1) // kv_chunk)
        carry = (torch.full((B, n_kv, G, q_chunk), -1e30, dtype=torch.float32,
                            device=dev),
                 torch.zeros((B, n_kv, G, q_chunk), dtype=torch.float32, device=dev),
                 torch.zeros((B, n_kv, G, q_chunk, Dh), dtype=torch.float32,
                             device=dev))
        for jk in range(lo, hi):
            carry = block(carry, q_blk, q0, jk)
        _, l, acc = carry
        outs.append((acc / l[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=3)  # (B,Kv,G,S,Dh)
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
    return_kv: bool = False,
):
    """Attention over ``x`` (k and v from ``kv_override`` for
    cross-attention): the output (B, S, D), and with ``return_kv`` also
    the (roped) k and the v it attended to."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = (x @ p.wq).reshape(B, S, n_heads, head_dim)
    if kv_override is None:
        k = (x @ p.wk).reshape(B, S, n_kv, head_dim)
        v = (x @ p.wv).reshape(B, S, n_kv, head_dim)
        if use_rope:
            k = rope(k, positions, rope_theta)
    else:
        k, v = kv_override
    if use_rope:
        q = rope(q, positions, rope_theta)
    if chunked:
        o = chunked_attention(q, k, v, n_kv=n_kv, causal=causal, window=window,
                              cap=cap, q_chunk=q_chunk, kv_chunk=kv_chunk,
                              schedule=schedule)
    else:
        o = full_attention(q, k, v, n_kv=n_kv, causal=causal, window=window,
                           cap=cap)
    out = o.reshape(B, S, n_heads * head_dim) @ p.wo
    return (out, k, v) if return_kv else out
