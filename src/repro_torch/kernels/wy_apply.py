"""K2: fused compact-WY application C - Y (T^T (Y^T C)) (port of
``src/repro/kernels/wy_apply.py``).

``wy_apply`` launches the CUDA kernel of ``csrc/wy_apply.cu`` over the lane
axis for b up to ``MAX_B``, and the three products of ``csrc/wide.cu``
(``wide.wy_apply_wide``) for a wider b; ``wy_apply_plain`` is its plain
PyTorch version. It takes float32 and bfloat16 at any b (``wy_apply_f32``,
``wy_apply_bf16``; above MAX_B the products of ``csrc/wide.cu`` and, at
bf16, ``csrc/wide_bf16.cu``, Y^T C and W in f32). At bf16 every product
runs on the tensor cores (``csrc/wgmma_bf16.cuh``: bf16 operands, f32
sums, an f32 operand split in two bf16 halves); ``ref.wy_apply_split``
emulates it in f32.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import backend, build, wide
from repro_torch.kernels.ref import wy_apply as wy_apply_plain  # noqa: F401

# The widest b of the tile engine (TILE_M in csrc/qr_common.cuh); a wider b
# takes the route of wide.wy_apply_wide.
MAX_B = 128

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.cache
def _kernel(sfx: str):
    return build.bind("wy_apply", f"wy_apply_{sfx}",
                      [_P, _P, _P, _L, _L, _P, _I, _I, _I, _I, _I, _P])


def wy_apply(Y: torch.Tensor, T: torch.Tensor, C: torch.Tensor,
             bn: Optional[int] = None, kbs: Optional[int] = None) -> torch.Tensor:
    """Q^T C for CUDA tensors of one dtype, f32 or bf16: Y
    (P, m, b), T (P, b, b), C (P, m, n), or the same without the lane axis,
    the result in their dtype; any b >= 1, and T need not be Y's own
    (all of it is read). C may be a strided view (unit column stride),
    such as the sweep's live window; the result is contiguous. ``bn`` is
    the kernel's column tile (32, 64 or 128; by default
    ``backend.tile_bn``, above MAX_B the tile of ``wide.gemm_plan``);
    ``kbs``, above MAX_B, the products' k range (``wide.gemm``). Neither
    changes the result's bits."""
    squeeze = C.dim() == 2
    Y3 = backend.contiguous_lanes(Y, "wy_apply")
    T3 = backend.contiguous_lanes(T, "wy_apply")
    C3 = backend.lanes(C, "wy_apply")
    sfx = backend.kernel_dtype("wy_apply", Y3, T3, C3)
    P, m, b = Y3.shape
    n = C3.shape[2]
    if T3.shape != (P, b, b) or C3.shape[:2] != (P, m):
        raise ValueError(f"wy_apply: shapes Y {tuple(Y.shape)}, T "
                         f"{tuple(T.shape)}, C {tuple(C.shape)} do not conform")
    if b < 1:
        raise ValueError(f"wy_apply: needs b >= 1, got {b}")
    if b > MAX_B:
        out = wide.wy_apply_wide(Y3, T3, C3, gemm=wide.gemm, bn=bn, kbs=kbs)
    else:
        bn = backend.launch_bn(P, n, C3, bn)
        out = torch.empty(P, m, n, device=C3.device, dtype=C3.dtype)
        if m and n:
            err = _kernel(sfx)(Y3.data_ptr(), T3.data_ptr(), C3.data_ptr(),
                            C3.stride(0), C3.stride(1), out.data_ptr(),
                            P, m, b, n, bn, backend.stream_ptr(C3))
            build.check(err, "wy_apply")
    if m and n:
        backend.count_launch("wy_apply", C3.dtype)
    return out[0] if squeeze else out
