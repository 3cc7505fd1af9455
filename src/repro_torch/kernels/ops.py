"""The dispatch seam of the port's kernels (port of
``src/repro/kernels/ops.py``).

One rule per call, no fallback:

* tensors on the CPU run the plain PyTorch version (``ref``);
* CUDA tensors run the hand-written CUDA kernel; a dtype other than
  float32 raises ``NotImplementedError`` (bf16 kernels are later work);
* anything else raises.

The JAX package's alignment padding, autotuned block shapes and
interpret/oracle modes are not ported: the CUDA kernels take any shape
they accept, and a failed launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, ref
from repro_torch.kernels import panel_qr as _panel
from repro_torch.kernels import stacked_qr as _stacked
from repro_torch.kernels import wy_apply as _wy


def _plain(op: str, *tensors: torch.Tensor) -> bool:
    """True for a call on CPU tensors, False for CUDA tensors."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        backend.note_plain(op)
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{op}: tensors on {sorted(kinds)}; the port runs on "
                     "CPU tensors (plain version) or CUDA tensors (kernel)")


def _lanewise(fn, *tensors, **kw):
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


def panel_qr(A: torch.Tensor, row_start=0):
    """(Y, T, R) of the masked Householder panel QR of A (..., m, b)."""
    if _plain("panel_qr", A):
        return _lanewise(ref.panel_qr, A, row_start=row_start)
    return _panel.panel_qr(A, row_start)


def wy_apply(Y: torch.Tensor, T: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Fused Q^T C = C - Y (T^T (Y^T C))."""
    if _plain("wy_apply", Y, T, C):
        return _lanewise(ref.wy_apply, Y, T, C)
    return _wy.wy_apply(Y, T, C)


def stacked_qr(R_top: torch.Tensor, R_bot: torch.Tensor):
    """(Y2, T, R) of the TSQR tree combine."""
    if _plain("stacked_qr", R_top, R_bot):
        return _lanewise(ref.stacked_qr, R_top, R_bot)
    return _stacked.stacked_qr(R_top, R_bot)


def stacked_apply(Y2, T, C_top, C_bot):
    """Fused trailing combine; returns (C_top_hat, C_bot_hat, W)."""
    if _plain("stacked_apply", Y2, T, C_top, C_bot):
        return _lanewise(ref.stacked_apply, Y2, T, C_top, C_bot)
    return _stacked.stacked_apply(Y2, T, C_top, C_bot)
