"""Plain PyTorch versions of the port's kernels K1-K6 (port of
``src/repro/kernels/ref.py``).

Batched over any leading (lane) axes. They bind the ``_``-prefixed pure
forms of ``repro_torch.core.householder``, never the dispatchers, so the
plain versions stay kernel-free and ``ops -> ref -> householder`` has no
cycle. ``ops`` runs them for CPU tensors (through ``lanewise``); the tests
and ``chip_smoke.py`` hold the CUDA kernels against them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import householder as hh

# (rtol, atol) for kernel-vs-plain comparisons, keyed by dtype; a copy of
# the JAX package's table (src/repro/kernels/ref.py).
_TOLERANCES = {
    "float32": (3e-4, 3e-4),
    "bfloat16": (5e-2, 5e-2),
    "float16": (2e-2, 2e-2),
    "float64": (1e-12, 1e-12),
}


def tolerances(dtype) -> Tuple[float, float]:
    """(rtol, atol) for comparing a kernel with its plain version at
    ``dtype`` (a torch or numpy dtype, or its name). Unknown dtypes get the
    f32 pair."""
    name = str(dtype).replace("torch.", "")
    return _TOLERANCES.get(name, _TOLERANCES["float32"])


def lanewise(fn, *tensors, **kw):
    """Run a plain version on contiguous lane-batched copies (a 2-D call is
    a batch of one), so a lane's bits do not depend on its layout or on
    how many lanes share the call, as the kernels guarantee on the GPU."""
    squeeze = tensors[0].dim() == 2
    args = [t.contiguous().unsqueeze(0) if squeeze else t.contiguous()
            for t in tensors]
    out = fn(*args, **kw)
    if not squeeze:
        return out
    return tuple(o[0] for o in out) if isinstance(out, tuple) else out[0]


def panel_qr(A: torch.Tensor, row_start):
    """(Y, T, R) of the masked Householder panel QR (K1)."""
    wy = hh._householder_qr_masked(A, row_start)
    return wy.Y, wy.T, wy.R


def wy_apply(Y: torch.Tensor, T: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Q^T C = C - Y (T^T (Y^T C)) (K2)."""
    return hh._apply_qt(Y, T, C)


def stacked_qr(R_top: torch.Tensor, R_bot: torch.Tensor):
    """(Y2, T, R) of the tree combine QR([R_top; R_bot]) (K3)."""
    sq = hh._stacked_qr(R_top, R_bot)
    return sq.Y2, sq.T, sq.R


def stacked_apply(Y2, T, C_top, C_bot):
    """Trailing combine (K4): returns (C_top_hat, C_bot_hat, W)."""
    return hh._stacked_apply_qt(hh.StackedQR(Y2=Y2, T=T, R=T), C_top, C_bot)


def panel_qr_apply(W: torch.Tensor, row_start, b: int):
    """The fused leaf (K5) as the unfused composition of the pure forms:
    masked QR of ``W[..., :b]``, Q^T over the whole window, and the b C'
    rows at ``row_start`` (clamped). Returns (Y, T, R, C, C')."""
    wy = hh._householder_qr_masked(W[..., :b], row_start)
    C = hh._apply_qt(wy.Y, wy.T, W)
    rs = hh._row_start(row_start, W.shape[:-2], W.device)
    return wy.Y, wy.T, wy.R, C, hh._rows_at(C, rs, b)


def fused_panel(window: torch.Tensor, k: int, *, b: int, m_loc_pad: int,
                levels: int):
    """The whole-panel megakernel (K6) as the stepped sweep's bodies over
    ``SimComm`` and the plain forms above (``fused_sweep.fused_panel_math``)."""
    from repro_torch.core.comm import SimComm
    from repro_torch.kernels.fused_sweep import fused_panel_math

    return fused_panel_math(SimComm(window.shape[0]), window, k, b=b,
                            m_loc_pad=m_loc_pad, levels=levels)


# -- the bf16 products' split (csrc/wgmma_bf16.cuh) ---------------------------
#
# At bf16 the CUDA kernels of K2 and K4 multiply a bf16 A by an f32 X (T^T Z,
# Y W) as two bf16 products on the tensor cores, A X_hi + A X_lo into one
# f32 sum. The functions below are that rule and an emulation of the two
# kernels with it, in f32 torch.matmul on the widened operands: the tests
# and chip_smoke.py hold the kernels to them within one bf16 ulp. No path
# calls them.


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of an f32 tensor as bf16: hi = bf16(x), lo = bf16(x - hi),
    both rounded to nearest even; hi + lo carries x to about 16 significant
    bits (x - hi is exact in f32)."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def split_matmul(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """A X for a bf16 A and an f32 X as the kernels compute it: A X_hi +
    A X_lo, in f32."""
    hi, lo = split_bf16(X)
    Af = A.float()
    return Af @ hi.float() + Af @ lo.float()


def wy_apply_split(Y, T, C, *, scale: bool = False):
    """K2 at bf16 as the kernels compute it: Z = Y^T C and W = T^T Z (Z
    split) in f32, out = C - Y W (W split) rounded once to C's dtype. With
    ``scale`` also the magnitude of each output's terms, the same chain on
    absolute values (|C| + |Y| |T|^T |Y|^T |C|), the scale of
    ``bf16_ulp_ok``."""
    Z = Y.float().mT @ C.float()
    W = split_matmul(T.mT, Z)
    out = (C.float() - split_matmul(Y, W)).to(C.dtype)
    if not scale:
        return out
    aY, aC = Y.float().abs(), C.float().abs()
    return out, aC + aY @ (T.float().abs().mT @ (aY.mT @ aC))


def stacked_apply_split(Y2, T, C_top, C_bot, *, scale: bool = False):
    """K4 at bf16 as the kernels compute it: inner = C_top + Y2^T C_bot and
    W = T^T inner (inner split) in f32; (C_top - W, C_bot - Y2 W (W split),
    W), each rounded once to C_top's dtype. With ``scale`` also the
    magnitudes of each output's terms (as ``wy_apply_split``)."""
    inner = C_top.float() + Y2.float().mT @ C_bot.float()
    W = split_matmul(T.mT, inner)
    dt = C_top.dtype
    outs = ((C_top.float() - W).to(dt),
            (C_bot.float() - split_matmul(Y2, W)).to(dt), W.to(dt))
    if not scale:
        return outs
    aY2, at, ab = Y2.float().abs(), C_top.float().abs(), C_bot.float().abs()
    sW = T.float().abs().mT @ (at + aY2.mT @ ab)
    return outs, (at + sW, ab + aY2 @ sW, sW)


def bf16_ulp_ok(got: torch.Tensor, want: torch.Tensor, scale=None) -> bool:
    """Whether each element of ``got`` is within one bf16 ulp of ``want``'s,
    the ulp taken at the larger of the two magnitudes and, when given, the
    element's ``scale``: the magnitude of the terms it sums (the
    ``scale=True`` outputs of the split emulations). Where a sum cancels
    far below its terms, two f32 orders (and the split, which carries an
    f32 operand to 2^-17 of each element) round to bf16 values further
    apart than the result's own ulp, but within one ulp of the terms'."""
    g, w = got.double(), want.double()
    m = torch.maximum(g.abs(), w.abs())
    if scale is not None:
        m = torch.maximum(m, scale.double())
    _, e = torch.frexp(m)
    return bool(((g - w).abs() <= torch.ldexp(torch.ones_like(g), e - 8)).all())
