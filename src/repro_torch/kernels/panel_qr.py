"""K1: masked Householder panel QR (port of
``src/repro/kernels/panel_qr.py``).

``panel_qr`` launches the CUDA kernel of ``csrc/panel_qr.cu`` over the
lane axis; ``panel_qr_plain`` is its plain PyTorch version. The source
file's note says what bounds the kernel and what its design does.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import backend, build
from repro_torch.kernels.ref import panel_qr as panel_qr_plain  # noqa: F401

MAX_B = 128
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.cache
def _kernel():
    smem = build.load("panel_qr").panel_qr_smem_bytes
    smem.argtypes, smem.restype = [_I, _I], ctypes.c_size_t
    fn = build.bind("panel_qr", "panel_qr_f32",
                    [_P, _L, _L, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    return fn, smem


def panel_qr(A: torch.Tensor, row_start):
    """(Y, T, R) of the masked panel QR of the CUDA f32 tensor A, shaped
    (P, m, b) or (m, b); ``row_start`` is a scalar or one value per lane.
    A may be a strided view (unit column stride)."""
    squeeze = A.dim() == 2
    A3 = backend.lanes(A, "panel_qr")
    P, m, b = A3.shape
    fn, smem = _kernel()
    if not 1 <= b <= MAX_B or m < b or m * b >= 2 ** 31:
        raise ValueError(f"panel_qr: needs 1 <= b <= {MAX_B} and m >= b, "
                         f"got m={m}, b={b}")
    if smem(m, b) > SMEM_LIMIT:
        raise ValueError(f"panel_qr: m={m} needs {smem(m, b)} bytes of "
                         f"shared memory, over {SMEM_LIMIT}")
    rs = backend.to_device(row_start, A3.device).to(torch.int32)
    rs = rs.reshape(-1).expand(P).contiguous()
    Y = torch.empty(P, m, b, device=A3.device, dtype=A3.dtype)
    T = torch.empty(P, b, b, device=A3.device, dtype=A3.dtype)
    R = torch.empty_like(T)
    work = torch.empty_like(Y)
    err = fn(A3.data_ptr(), A3.stride(0), A3.stride(1), rs.data_ptr(),
             Y.data_ptr(), T.data_ptr(), R.data_ptr(), work.data_ptr(),
             P, m, b, backend.stream_ptr(A3))
    build.check(err, "panel_qr")
    backend.count_launch("panel_qr")
    if squeeze:
        return Y[0], T[0], R[0]
    return Y, T, R
