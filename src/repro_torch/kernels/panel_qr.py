"""K1: masked Householder panel QR (port of
``src/repro/kernels/panel_qr.py``).

``panel_qr`` launches the CUDA kernel of ``csrc/panel_qr.cu``, a team of
``backend.team_blocks(m, b)`` blocks per lane, for panels of up to
``MAX_B`` columns, and the blocked route of ``kernels/wide.py`` (that
kernel on sub-panels of 128 columns, the products of ``csrc/wide.cu``
between them and in the T join) for wider ones; ``panel_qr_plain`` is its plain PyTorch
version. The source files' notes say what bounds the kernels and what
their design does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, build, wide
from repro_torch.kernels.ref import panel_qr as panel_qr_plain  # noqa: F401

# The widest panel of the team body; a wider panel takes the blocked route.
MAX_B = wide.NB

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.cache
def _kernel():
    return build.bind("panel_qr", "panel_qr_f32",
                      [_P, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])


@functools.cache
def _entry(name: str, restype):
    f = getattr(build.load("panel_qr"), name)
    f.argtypes, f.restype = [_I, _I, _I], restype
    return f


def work_floats(m: int, b: int, C: int) -> int:
    """Floats of global scratch one lane's team needs (0 when its slabs
    fit in shared memory), as the kernel computes it."""
    return _entry("panel_qr_work_floats", ctypes.c_size_t)(m, b, C)


def smem_bytes(m: int, b: int, C: int) -> int:
    """Shared memory of one team block, as the kernel computes it."""
    return _entry("panel_qr_smem_bytes", ctypes.c_size_t)(m, b, C)


def max_active_clusters(m: int, b: int) -> int:
    """How many teams (clusters of ``team_blocks(m, b)`` blocks) of K1 the
    card holds at once at an (m x b) panel's shared memory."""
    n = ctypes.c_int(0)
    f = build.bind("panel_qr", "panel_qr_max_clusters",
                   [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
    build.check(f(m, b, backend.team_blocks(m, b), ctypes.byref(n)),
                "panel_qr_max_clusters")
    return n.value


def _launch(A3: torch.Tensor, rs: torch.Tensor):
    """(Y, T, R) of the team kernel on A3 (P, m, b), b <= MAX_B, with int32
    row starts ``rs`` (P,) on the card."""
    P, m, b = A3.shape
    C = backend.team_blocks(m, b)
    Y = torch.empty(P, m, b, device=A3.device, dtype=A3.dtype)
    T = torch.empty(P, b, b, device=A3.device, dtype=A3.dtype)
    R = torch.empty_like(T)
    work = torch.empty(P * work_floats(m, b, C), device=A3.device,
                       dtype=A3.dtype)
    err = _kernel()(A3.data_ptr(), A3.stride(0), A3.stride(1), rs.data_ptr(),
                    Y.data_ptr(), T.data_ptr(), R.data_ptr(), work.data_ptr(),
                    P, m, b, C, backend.stream_ptr(A3))
    build.check(err, "panel_qr")
    return Y, T, R


def sub_qr(A3: torch.Tensor, rs: torch.Tensor):
    """The team kernel on a sub-panel of a wide call (``wide.panel_qr_blocked``
    and K3's wide route): counted in ``backend.SUB_LAUNCHES``."""
    out = _launch(A3, rs.to(torch.int32).contiguous())
    backend.count_sub("panel_qr_kernel")
    return out


def panel_qr(A: torch.Tensor, row_start):
    """(Y, T, R) of the masked panel QR of the CUDA f32 tensor A, shaped
    (P, m, b) or (m, b), any b >= 1 with m >= b; ``row_start`` is a scalar
    or one value per lane. A may be a strided view (unit column stride).
    Up to MAX_B columns each lane runs on a team of
    ``backend.team_blocks(m, b)`` blocks; a wider panel runs in sub-panels
    of 128 columns (``wide.panel_qr_blocked``)."""
    squeeze = A.dim() == 2
    A3 = backend.lanes(A, "panel_qr")
    P, m, b = A3.shape
    if b < 1 or m < b or m * b >= 2 ** 31:
        raise ValueError(f"panel_qr: needs b >= 1 and m >= b, got m={m}, b={b}")
    rs = backend.to_device(row_start, A3.device).to(torch.int32)
    rs = rs.reshape(-1).expand(P).contiguous()
    if b <= MAX_B:
        Y, T, R = _launch(A3, rs)
    else:
        Y, T, R = wide.panel_qr_blocked(A3, rs, qr=sub_qr, apply=wide.cuda_apply,
                                        gemm=wide.gemm)
    backend.count_launch("panel_qr")
    if squeeze:
        return Y[0], T[0], R[0]
    return Y, T, R
