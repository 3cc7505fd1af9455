"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427; port
of ``src/repro/models/rglru.py``).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Training and prefill take a log-depth scan over the sequence (Hillis-Steele
doubling: about log2 S passes over the whole (B, S, W) tensor, where the
reference takes ``jax.lax.associative_scan``; the two group the products
differently and agree to round-off); decode is one step. The block wraps
the LRU in the Griffin layout: in-proj (x, gate) -> temporal conv1d ->
RG-LRU -> gated out-proj. As in the reference, h is cast to the activation
dtype before the last position is kept as the float32 state.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.ssm import depthwise_conv, softplus

_C = 8.0  # the paper's fixed constant


class RGLRUParams(NamedTuple):
    w_in: torch.Tensor       # (D, 2*W)  -> (x branch, gate branch)
    conv_w: torch.Tensor     # (conv_width, W) depthwise
    w_a: torch.Tensor        # (W, W) recurrence gate
    b_a: torch.Tensor        # (W,)
    w_x: torch.Tensor        # (W, W) input gate
    b_x: torch.Tensor        # (W,)
    a_param: torch.Tensor    # (W,)  Lambda
    w_out: torch.Tensor      # (W, D)


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, W) float32
    conv: torch.Tensor       # (B, conv_width-1, W)


def _lru_scan(a: torch.Tensor, u: torch.Tensor, h0: Optional[torch.Tensor]):
    """h_t = a_t * h_{t-1} + u_t over S by doubling. a, u: (B, S, W); h0,
    when given, is folded in as a virtual first element (a = 1, u = h0)."""
    if h0 is not None:
        a = torch.cat([torch.ones_like(a[:, :1]), a], dim=1)
        u = torch.cat([h0[:, None], u], dim=1)
    d, S = 1, a.shape[1]
    while d < S:
        # element t absorbs the segment ending at t - d
        u = torch.cat([u[:, :d], a[:, d:] * u[:, :-d] + u[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return u[:, 1:] if h0 is not None else u


def rglru_forward(
    p: RGLRUParams,
    x: torch.Tensor,  # (B, S, D)
    *,
    state: Optional[RGLRUState] = None,
    return_state: bool = False,
):
    """The recurrent block; with ``return_state`` also the new
    ``RGLRUState``."""
    S = x.shape[1]
    xz = x @ p.w_in
    xb, gate = torch.chunk(xz, 2, dim=-1)  # (B,S,W) each
    xb, new_conv_tail = depthwise_conv(
        xb, p.conv_w, state.conv if state is not None else None)

    r = torch.sigmoid(xb @ p.w_a + p.b_a)
    i = torch.sigmoid(xb @ p.w_x + p.b_x)
    log_a = -_C * softplus(p.a_param.float()) * r.float()
    a = torch.exp(log_a)
    gated_x = (i * xb).float()
    u = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * gated_x

    h0 = state.h.float() if state is not None else None
    if S == 1 and state is not None:
        h = (a[:, 0] * h0 + u[:, 0])[:, None]
    else:
        h = _lru_scan(a, u, h0)
    h = h.to(x.dtype)

    out = (h * F.gelu(gate, approximate="tanh")) @ p.w_out
    if return_state:
        return out, RGLRUState(h=h[:, -1].float(), conv=new_conv_tail)
    return out
