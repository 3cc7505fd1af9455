"""K1: masked Householder panel QR (port of
``src/repro/kernels/panel_qr.py``).

``panel_qr`` launches the CUDA kernel of ``csrc/panel_qr.cu``, a team of
``backend.team_blocks(m, b)`` blocks per lane; ``panel_qr_plain`` is its
plain PyTorch version. The source file's note says what bounds the
kernel and what its design does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import panel_qr as panel_qr_plain  # noqa: F401

MAX_B = 128

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


def panel_qr(A: torch.Tensor, row_start):
    """(Y, T, R) of the masked panel QR of the CUDA f32 tensor A, shaped
    (P, m, b) or (m, b); ``row_start`` is a scalar or one value per lane.
    A may be a strided view (unit column stride). Each lane runs on a team
    of ``backend.team_blocks(m, b)`` blocks."""
    squeeze = A.dim() == 2
    A3 = backend.lanes(A, "panel_qr")
    P, m, b = A3.shape
    if not 1 <= b <= MAX_B or m < b or m * b >= 2 ** 31:
        raise ValueError(f"panel_qr: needs 1 <= b <= {MAX_B} and m >= b, "
                         f"got m={m}, b={b}")
    C = backend.team_blocks(m, b)
    fn = _kernel()
    rs = backend.to_device(row_start, A3.device).to(torch.int32)
    rs = rs.reshape(-1).expand(P).contiguous()
    Y = torch.empty(P, m, b, device=A3.device, dtype=A3.dtype)
    T = torch.empty(P, b, b, device=A3.device, dtype=A3.dtype)
    R = torch.empty_like(T)
    work = torch.empty(P * work_floats(m, b, C), device=A3.device,
                       dtype=A3.dtype)
    err = fn(A3.data_ptr(), A3.stride(0), A3.stride(1), rs.data_ptr(),
             Y.data_ptr(), T.data_ptr(), R.data_ptr(), work.data_ptr(),
             P, m, b, C, backend.stream_ptr(A3))
    build.check(err, "panel_qr")
    backend.count_launch("panel_qr")
    if squeeze:
        return Y[0], T[0], R[0]
    return Y, T, R
