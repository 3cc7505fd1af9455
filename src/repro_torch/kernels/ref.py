"""Plain PyTorch versions of the port's kernels K1-K4 (port of
``src/repro/kernels/ref.py``).

Batched over any leading (lane) axes. They bind the ``_``-prefixed pure
forms of ``repro_torch.core.householder``, never the dispatchers, so the
plain versions stay kernel-free and ``ops -> ref -> householder`` has no
cycle. ``ops`` runs them for CPU tensors; the tests and ``chip_smoke.py``
hold the CUDA kernels against them.
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
