"""K3: QR of two stacked upper triangles, and K4: the fused trailing
combine (port of ``src/repro/kernels/stacked_qr.py``).

``stacked_qr`` and ``stacked_apply`` launch the CUDA kernels of
``csrc/stacked_qr.cu`` over the lane axis for b up to ``MAX_B``; for a
wider b K3 is K1's one wide launch on the stacked triangles
(``panel_qr.launch_wide``) and K4 the products of ``csrc/wide.cu``
(``wide.stacked_apply_wide``); ``stacked_qr_plain`` and
``stacked_apply_plain`` are their plain PyTorch versions.
``stacked_qr_composed`` is K3's wide route as separate launches, the bit
oracle of the one launch.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import backend, build, wide
from repro_torch.kernels import panel_qr as _panel
from repro_torch.kernels.ref import (  # noqa: F401
    stacked_apply as stacked_apply_plain,
    stacked_qr as stacked_qr_plain,
)

# The widest b of K3's one-block body (its stack in shared memory) and of
# K4's tile engine; a wider b takes the routes of kernels/wide.py.
MAX_B = 128

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _qr_kernel():
    return build.bind("stacked_qr", "stacked_qr_f32",
                      [_P, _P, _P, _P, _P, _I, _I, _P])


@functools.cache
def _apply_kernel():
    return build.bind("stacked_qr", "stacked_apply_f32",
                      [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])


def smem_bytes(b: int) -> int:
    """Shared memory of one block of K3 (one lane) at b, as the kernel
    computes it."""
    f = build.load("stacked_qr").stacked_qr_smem_bytes
    f.argtypes, f.restype = [_I], ctypes.c_size_t
    return f(b)


def _b(b: int, op: str) -> None:
    if b < 1:
        raise ValueError(f"{op}: needs b >= 1, got {b}")


def stacked_qr(R_top: torch.Tensor, R_bot: torch.Tensor):
    """(Y2, T, R) of QR([R_top; R_bot]) for contiguous CUDA f32 tensors
    (P, b, b) or (b, b), any b >= 1 (above MAX_B through K1's one wide
    launch on the stacks)."""
    squeeze = R_top.dim() == 2
    Rt, Rb = _pair(R_top, R_bot, "stacked_qr")
    P, b, _ = Rt.shape
    if b <= MAX_B:
        Y2, T, R = (torch.empty_like(Rt) for _ in range(3))
        err = _qr_kernel()(Rt.data_ptr(), Rb.data_ptr(), Y2.data_ptr(),
                           T.data_ptr(), R.data_ptr(), P, b,
                           backend.stream_ptr(Rt))
        build.check(err, "stacked_qr")
    else:
        Y2, T, R = _panel.launch_wide(Rt, None, bot=Rb)
    backend.count_launch("stacked_qr")
    if squeeze:
        return Y2[0], T[0], R[0]
    return Y2, T, R


def _pair(R_top: torch.Tensor, R_bot: torch.Tensor, op: str):
    Rt = backend.contiguous_lanes(R_top, op)
    Rb = backend.contiguous_lanes(R_bot, op)
    P, b, b2 = Rt.shape
    if Rb.shape != Rt.shape or b != b2:
        raise ValueError(f"{op}: shapes {tuple(R_top.shape)} and "
                         f"{tuple(R_bot.shape)} are not two (P, b, b)")
    _b(b, op)
    return Rt, Rb


def stacked_qr_composed(R_top: torch.Tensor, R_bot: torch.Tensor):
    """``stacked_qr`` above MAX_B columns as separate launches
    (``wide.stacked_qr_wide`` through ``panel_qr.panel_qr_composed``'s
    kernels), counted in ``backend.SUB_LAUNCHES`` alone: the bit oracle and
    time yardstick of the one launch; no path calls it."""
    squeeze = R_top.dim() == 2
    Rt, Rb = _pair(R_top, R_bot, "stacked_qr_composed")
    out = wide.stacked_qr_wide(Rt, Rb, qr=_panel.sub_qr, apply=wide.cuda_apply,
                               gemm=wide.gemm)
    return tuple(x[0] for x in out) if squeeze else out


def stacked_apply(Y2: torch.Tensor, T: torch.Tensor, C_top: torch.Tensor,
                  C_bot: torch.Tensor, bn: Optional[int] = None):
    """(C_top - W, C_bot - Y2 W, W) with W = T^T (C_top + Y2^T C_bot), for
    contiguous CUDA f32 tensors: Y2, T (P, b, b), upper triangular as
    ``stacked_qr`` makes them (up to MAX_B the kernel skips their zero
    triangles; above it ``wide.stacked_apply_wide`` reads all of them, as
    the plain version does); C_top, C_bot (P, b, n); or the same without
    the lane axis. ``bn`` is
    the kernel's column tile (32, 64 or 128; by default
    ``backend.tile_bn``, above MAX_B the tile of ``wide.gemm_plan``); it
    does not change the result's bits."""
    squeeze = C_top.dim() == 2
    Y3 = backend.contiguous_lanes(Y2, "stacked_apply")
    T3 = backend.contiguous_lanes(T, "stacked_apply")
    Ct = backend.contiguous_lanes(C_top, "stacked_apply")
    Cb = backend.contiguous_lanes(C_bot, "stacked_apply")
    P, b, n = Ct.shape
    if Y3.shape != (P, b, b) or T3.shape != (P, b, b) or Cb.shape != Ct.shape:
        raise ValueError("stacked_apply: shapes do not conform: "
                         f"{[tuple(x.shape) for x in (Y2, T, C_top, C_bot)]}")
    _b(b, "stacked_apply")
    if b > MAX_B:
        ot, ob, W = wide.stacked_apply_wide(Y3, T3, Ct, Cb, gemm=wide.gemm,
                                            bn=bn)
    else:
        bn = backend.launch_bn(P, n, Ct, bn)
        ot, ob, W = (torch.empty_like(Ct) for _ in range(3))
        if n:
            err = _apply_kernel()(Y3.data_ptr(), T3.data_ptr(), Ct.data_ptr(),
                                  Cb.data_ptr(), ot.data_ptr(), ob.data_ptr(),
                                  W.data_ptr(), P, b, n, bn,
                                  backend.stream_ptr(Ct))
            build.check(err, "stacked_apply")
    if n:
        backend.count_launch("stacked_apply")
    if squeeze:
        return ot[0], ob[0], W[0]
    return ot, ob, W
