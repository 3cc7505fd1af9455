"""Mamba2 SSD (state-space duality) block, an attention-free token mixer
(port of ``src/repro/models/ssm.py``).

The chunked SSD algorithm (Dao & Gu 2024, arXiv:2405.21060) in matmul
form: a within-chunk "attention-like" term plus the inter-chunk state
recurrence, carried here by a Python loop over the chunks. Decode keeps
the per-head state h (B, H, P, N) and the conv window.

The arithmetic is the reference's, dtype for dtype: the scores C . B in
the activation dtype, the decay kernel, dt and the state recurrence in
float32, the state entering a chunk rounded to the activation dtype for
the inter-chunk output (``h_prev.astype(Cc.dtype)``), the output cast
back to the activation dtype. One departure: the reference builds the
decay kernel as ``where(tri, exp(diff), 0)``; above the diagonal ``diff``
is positive and grows with the chunk, so ``exp`` overflows there and the
backward pass returns 0 * inf = NaN (at mamba2's chunk of 256 with its
init's A). The port takes ``exp(where(tri, diff, -inf))``: the same
forward values, and the same gradients wherever the reference's are
finite.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class SSMParams(NamedTuple):
    w_in: torch.Tensor      # (D, d_inner*2 + 2*G*N + H)  fused input projection
    conv_w: torch.Tensor    # (conv_width, conv_dim) depthwise conv
    A_log: torch.Tensor     # (H,)
    Dskip: torch.Tensor     # (H,)
    dt_bias: torch.Tensor   # (H,)
    norm_scale: torch.Tensor  # (d_inner,)
    w_out: torch.Tensor     # (d_inner, D)


class SSMState(NamedTuple):
    h: torch.Tensor         # (B, H, P, N) SSD state, float32
    conv: torch.Tensor      # (B, conv_width-1, conv_dim) conv tail


def _dims(cfg_d_model: int, ssm) -> Tuple[int, int, int, int, int]:
    d_inner = ssm.expand * cfg_d_model
    H = d_inner // ssm.head_dim
    return d_inner, H, ssm.head_dim, ssm.n_groups, ssm.d_state


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    threshold (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def depthwise_conv(xs: torch.Tensor, conv_w: torch.Tensor,
                   tail: Optional[torch.Tensor]):
    """The causal depthwise conv over (B, S, C) features as ``cw`` shifted
    multiply-adds, from the carried ``tail`` (B, cw-1, C) or zeros: the
    output and the new tail."""
    S, cw = xs.shape[1], conv_w.shape[0]
    if tail is not None:
        x_in = torch.cat([tail, xs], dim=1)
    else:
        x_in = F.pad(xs, (0, 0, cw - 1, 0))
    acc = torch.zeros_like(xs)
    for c in range(cw):
        acc = acc + x_in[:, c:c + S] * conv_w[c][None, None, :]
    return acc, x_in[:, -(cw - 1):]


def ssd_chunked(
    x: torch.Tensor,    # (B, S, H, P)
    dt: torch.Tensor,   # (B, S, H)   (post-softplus, float32)
    A: torch.Tensor,    # (H,) negative
    Bm: torch.Tensor,   # (B, S, G, N)
    Cm: torch.Tensor,   # (B, S, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), h_final (B,H,P,N) float32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S = {S} is not a multiple of the chunk {chunk}")
    nc = S // chunk
    rep = H // G

    xc = x.reshape(Bsz, nc, chunk, H, P)
    dtc = dt.reshape(Bsz, nc, chunk, H)
    Bc = torch.repeat_interleave(Bm.reshape(Bsz, nc, chunk, G, N), rep, dim=3)
    Cc = torch.repeat_interleave(Cm.reshape(Bsz, nc, chunk, G, N), rep, dim=3)

    dA = dtc * A[None, None, None, :]           # (B,nc,c,H) negative increments
    cums = torch.cumsum(dA, dim=2)               # within-chunk cumulative
    seg_end = cums[:, :, -1, :]                  # (B,nc,H) total chunk decay

    # within-chunk decay kernel L[s,t] = exp(cums[s] - cums[t]) for s >= t,
    # 0 above the diagonal without an overflowing exp there
    diff = cums[:, :, :, None, :] - cums[:, :, None, :, :]  # (B,nc,s,t,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    L = torch.exp(torch.where(tri, diff, float("-inf")))
    # scores[s,t] = C_s . B_t, in the activation dtype
    scores = torch.einsum("bqchn,bqthn->bqcth", Cc, Bc)
    # y_intra[s] = sum_t L[s,t] * scores[s,t] * dt_t * x_t
    w = scores.float() * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bqcth,bqthp->bqchp", w, xc.float())

    # chunk states: sum_t exp(seg_end - cums[t]) dt_t B_t x_t^T
    decay_to_end = torch.exp(seg_end[:, :, None, :] - cums)   # (B,nc,c,H)
    wx = (decay_to_end * dtc)[..., None] * xc.float()         # (B,nc,c,H,P)
    states = torch.einsum("bqthp,bqthn->bqhpn", wx, Bc.float())

    # inter-chunk recurrence over nc: the state entering each chunk
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    decay = torch.exp(seg_end)
    h_prev = []
    for q in range(nc):
        h_prev.append(h)
        h = h * decay[:, q][:, :, None, None] + states[:, q]
    h_prev = torch.stack(h_prev, dim=1)          # (B,nc,H,P,N)

    # y_inter[s] = exp(cums[s]) * C_s . h_prev, h_prev in the activation dtype
    y_inter = torch.einsum(
        "bqchn,bqhpn->bqchp", torch.exp(cums)[..., None] * Cc.float(),
        h_prev.to(Cc.dtype).float())

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype), h


def ssm_forward(
    p: SSMParams,
    x: torch.Tensor,   # (B, S, D)
    *,
    d_model: int,
    ssm_cfg,
    state: Optional[SSMState] = None,
    return_state: bool = False,
):
    """The Mamba2 block: in-proj -> conv -> SSD -> gated norm -> out-proj;
    with ``return_state`` also the new ``SSMState``."""
    B, S, D = x.shape
    d_inner, H, P, G, N = _dims(d_model, ssm_cfg)
    conv_dim = d_inner + 2 * G * N

    zxbcdt = x @ p.w_in
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    acc, new_conv_tail = depthwise_conv(
        xbc, p.conv_w, state.conv if state is not None else None)
    xbc_conv = F.silu(acc)

    xs, Bm, Cm = torch.split(xbc_conv, [d_inner, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    dt = softplus(dt_raw.float() + p.dt_bias)          # (B,S,H)
    A = -torch.exp(p.A_log.float())

    if S == 1 and state is not None:
        # decode fast path: one recurrence step, no chunking
        dA = torch.exp(dt[:, 0] * A[None, :])                    # (B,H)
        Bh = torch.repeat_interleave(Bm[:, 0], H // G, dim=1).float()  # (B,H,N)
        Ch = torch.repeat_interleave(Cm[:, 0], H // G, dim=1).float()
        inc = (dt[:, 0][:, :, None, None] * xs[:, 0].float()[:, :, :, None]
               * Bh[:, :, None, :])
        h_new = state.h * dA[:, :, None, None] + inc
        y = torch.einsum("bhn,bhpn->bhp", Ch, h_new)[:, None]   # (B,1,H,P)
        y = y.to(x.dtype)
        h_final = h_new
    else:
        y, h_final = ssd_chunked(xs, dt, A, Bm, Cm, min(ssm_cfg.chunk, S),
                                 state.h if state is not None else None)

    y = y + xs * p.Dskip[None, None, :, None]
    y = y.reshape(B, S, d_inner)
    # gated RMSNorm (mamba2 style)
    yf = y.float() * F.silu(z.float())
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(var + 1e-6) * (1.0 + p.norm_scale.float())
    out = yf.to(x.dtype) @ p.w_out
    if return_state:
        return out, SSMState(h=h_final, conv=new_conv_tail)
    return out
