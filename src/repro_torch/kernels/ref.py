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
