"""The dispatch seam of the port's kernels (port of
``src/repro/kernels/ops.py``).

One rule per call, no fallback:

* tensors on the CPU run the plain PyTorch version (``ref``);
* tensors on the meta device run the plain version too, for their shapes
  alone (the dry run, ``launch/dryrun.py``): no launch is counted and no
  engine is reported;
* CUDA tensors run the hand-written CUDA kernel: float32 and bfloat16 at
  any panel width (any other dtype raises ``NotImplementedError``); a call
  whose CUDA tensors mix dtypes raises ``ValueError``;
* anything else raises.

K2 and K4 take the autotuner's winner for the call's cell, its column
tile and above 128 columns the products' k range (``autotune.lookup``, a
dict probe; nothing when no cell is loaded), else the static default.
No candidate changes a bit. The JAX package's
alignment padding and interpret/oracle modes are not ported: the CUDA
kernels take any shape they accept, and a failed launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune, backend, ref
from repro_torch.kernels import fused_sweep as _fused
from repro_torch.kernels import panel_qr as _panel
from repro_torch.kernels import stacked_qr as _stacked
from repro_torch.kernels import wy_apply as _wy


def _plain(op: str, *tensors: torch.Tensor) -> bool:
    """True for a call on CPU (or meta) tensors, False for CUDA tensors."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        backend.note_plain(op)
        return True
    if kinds == {"meta"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{op}: tensors on {sorted(kinds)}; the port runs on "
                     "CPU tensors (plain version) or CUDA tensors (kernel)")


def panel_qr(A: torch.Tensor, row_start=0):
    """(Y, T, R) of the masked Householder panel QR of A (..., m, b)."""
    if _plain("panel_qr", A):
        return ref.lanewise(ref.panel_qr, A, row_start=row_start)
    return _panel.panel_qr(A, row_start)


def _lanes(x: torch.Tensor) -> int:
    return x.shape[0] if x.dim() == 3 else 1


def wy_apply(Y: torch.Tensor, T: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Fused Q^T C = C - Y (T^T (Y^T C))."""
    if _plain("wy_apply", Y, T, C):
        return ref.lanewise(ref.wy_apply, Y, T, C)
    tuned = autotune.lookup("wy_apply", (_lanes(C), *Y.shape[-2:], C.shape[-1]),
                            C.dtype)
    return _wy.wy_apply(Y, T, C, bn=tuned.get("bn"), kbs=tuned.get("kbs"))


def stacked_qr(R_top: torch.Tensor, R_bot: torch.Tensor):
    """(Y2, T, R) of the TSQR tree combine."""
    if _plain("stacked_qr", R_top, R_bot):
        return ref.lanewise(ref.stacked_qr, R_top, R_bot)
    return _stacked.stacked_qr(R_top, R_bot)


def stacked_apply(Y2, T, C_top, C_bot):
    """Fused trailing combine; returns (C_top_hat, C_bot_hat, W)."""
    if _plain("stacked_apply", Y2, T, C_top, C_bot):
        return ref.lanewise(ref.stacked_apply, Y2, T, C_top, C_bot)
    tuned = autotune.lookup("stacked_apply", (_lanes(C_top), *C_top.shape[-2:]),
                            C_top.dtype)
    return _stacked.stacked_apply(Y2, T, C_top, C_bot, bn=tuned.get("bn"),
                                  kbs=tuned.get("kbs"))


def panel_qr_apply(W: torch.Tensor, row_start=0, b=None):
    """Fused leaf: masked QR of ``W[..., :b]``, Q^T over the whole window
    and the C' rows at ``row_start``, one launch (K5). Returns
    (Y, T, R, C, C')."""
    if b is None:
        b = W.shape[-1]
    if _plain("panel_qr_apply", W):
        return ref.lanewise(ref.panel_qr_apply, W, row_start=row_start, b=b)
    return _fused.panel_qr_apply(W, row_start, b)


def fused_panel(window: torch.Tensor, k: int, *, b: int, m_loc_pad: int,
                levels: int):
    """All of panel ``k``'s sweep points over the (P, m, w) window (K6);
    returns the ``fused_sweep.FUSED_FIELDS`` outputs and ``tops``."""
    if _plain("fused_panel", window):
        return ref.fused_panel(window, k, b=b, m_loc_pad=m_loc_pad,
                               levels=levels)
    return _fused.fused_panel(window, k, b=b, m_loc_pad=m_loc_pad,
                              levels=levels)
