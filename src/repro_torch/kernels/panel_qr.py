"""K1: masked Householder panel QR (port of
``src/repro/kernels/panel_qr.py``).

``panel_qr`` launches the CUDA kernel of ``csrc/panel_qr.cu``, a team of
``backend.team_blocks(m, b)`` blocks per lane, for panels of up to
``MAX_B`` columns, and for wider ones the one cooperative launch of
``csrc/panel_qr_wide.cu`` (the blocked route of ``kernels/wide.py`` in
one kernel: the team body on sub-panels of 128 columns, on thread-block
clusters or, where one round of clusters cannot take every lane's team,
on a plain grid exchanging through global memory; the products between
sub-panels and in the T join as grid-wide tile phases, the far columns'
updated by idle blocks during the next team phase), which also takes
K3's wide route; ``panel_qr_plain`` is its plain PyTorch version. It
takes float32 and bfloat16 panels at any width (``panel_qr_f32``,
``panel_qr_bf16``; above 128 columns ``panel_qr_wide_f32`` and, in
``csrc/panel_qr_wide_bf16.cu``, ``panel_qr_wide_bf16``, which runs the
f32 launch's body on a widened copy): the bf16 kernels' bits are the f32
kernels' on the widened panel, rounded once.
``panel_qr_composed`` runs the same blocked route as separate launches
(K1's team kernel a sub-panel, ``wide.gemm`` between them): the bit
oracle and time yardstick of the one launch, which no path calls. The
source files' notes say what bounds the kernels and what their design
does.
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
def _kernel(sfx: str):
    return build.bind("panel_qr", f"panel_qr_{sfx}",
                      [_P, _L, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])


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
    """(Y, T, R) of the team kernel on A3 (P, m, b), b <= MAX_B, f32 or
    bf16, with int32 row starts ``rs`` (P,) on the card."""
    P, m, b = A3.shape
    sfx = backend.kernel_suffix(A3.dtype)
    C = backend.team_blocks(m, b)
    Y = torch.empty(P, m, b, device=A3.device, dtype=A3.dtype)
    T = torch.empty(P, b, b, device=A3.device, dtype=A3.dtype)
    R = torch.empty_like(T)
    work = torch.empty(P * work_floats(m, b, C), device=A3.device,
                       dtype=torch.float32)
    gram = backend.gram_scratch(P, b, A3)
    err = _kernel(sfx)(A3.data_ptr(), A3.stride(0), A3.stride(1),
                       rs.data_ptr(), Y.data_ptr(), T.data_ptr(), R.data_ptr(),
                       backend.ptr(gram), work.data_ptr(), P, m, b, C,
                       backend.stream_ptr(A3))
    build.check(err, "panel_qr")
    return Y, T, R


def sub_qr(A3: torch.Tensor, rs: torch.Tensor):
    """The team kernel on a sub-panel of the composed route
    (``panel_qr_composed`` and ``stacked_qr.stacked_qr_composed``): counted
    in ``backend.SUB_LAUNCHES``."""
    out = _launch(A3, rs.to(torch.int32).contiguous())
    backend.count_sub("panel_qr_kernel")
    return out


# The library of the wide launch's entry points at each kernel suffix.
_WIDE_LIBS = {"f32": "panel_qr_wide", "bf16": "panel_qr_wide_bf16"}


@functools.cache
def _wide_kernel(sfx: str):
    return build.bind(_WIDE_LIBS[sfx], f"panel_qr_wide_{sfx}",
                      [_P, _L, _L] + [_P] * 9 + [_I] * 4 + [_P])


@functools.cache
def _wide_entry(name: str, nargs: int, restype=ctypes.c_size_t,
                lib: str = "panel_qr_wide"):
    f = getattr(build.load(lib), name)
    f.argtypes, f.restype = [_I] * nargs, restype
    return f


@functools.cache
def wide_launch_shape(P: int, m: int, b: int, device: int = 0,
                      sfx: str = "f32"):
    """(cluster size, grid in blocks) of the one launch of P lanes at an
    (m x b) panel (K3: m = 2b, the stack's rows) on card ``device``, of the
    f32 or the bf16 kernels (``sfx``): clusters of the largest team of its
    sub-panels, as many as the card holds at once; or (0, grid), a plain
    cooperative grid whose team phases exchange through global memory,
    where one round of clusters cannot take every lane's team and that grid
    can. Raises RuntimeError when the card cannot hold a team of the
    launch."""
    cluster, grid = ctypes.c_int(0), ctypes.c_int(0)
    name = "panel_qr_wide_shape" + ("" if sfx == "f32" else f"_{sfx}")
    f = build.bind(_WIDE_LIBS[sfx], name,
                   [_I, _I, _I, ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int)])
    with torch.cuda.device(device):
        err = f(P, m, b, ctypes.byref(cluster), ctypes.byref(grid))
    if err:
        raise RuntimeError(f"panel_qr: the card cannot hold a team of the wide "
                           f"launch at m={m}, b={b} (cudaError {err})")
    return cluster.value, grid.value


def launch_wide(A3: torch.Tensor, rs, bot=None):
    """(Y, T, R) of the blocked QR above MAX_B columns in one launch: of
    A3 (P, m, b) from int32 row starts ``rs`` (P,) on the card; or, with
    ``bot``, of the stacks [triu(A3); triu(bot)] of two contiguous
    (P, b, b) triangles at row start 0, returning (Y2, T, R) with
    Y2 = triu(Y[b:]) (K3's wide route), in A3's dtype (f32 or bf16). At f32
    every output equals ``panel_qr_composed``'s (or
    ``stacked_qr_composed``'s) bit for bit; at bf16 the f32 launch's on the
    widened inputs, rounded once."""
    P, m, b = A3.shape
    if bot is not None:
        m = 2 * b
    sfx = backend.kernel_suffix(A3.dtype)
    wide_launch_shape(P, m, b, A3.device.index or 0, sfx)
    dev, dt, f32 = A3.device, A3.dtype, torch.float32
    Y = torch.empty(P, b if bot is not None else m, b, device=dev, dtype=dt)
    T = torch.empty(P, b, b, device=dev, dtype=dt)
    R = torch.empty_like(T)
    # the launch's scratch is float at either dtype
    work = torch.empty(P * _wide_entry("panel_qr_wide_work_floats", 2)(m, b),
                       device=dev, dtype=f32)
    scratch_floats = (_wide_entry("panel_qr_wide_scratch_floats", 4)
                      if sfx == "f32" else
                      _wide_entry("panel_qr_wide_scratch_floats_bf16", 4,
                                  lib=_WIDE_LIBS[sfx]))
    scratch = torch.empty(scratch_floats(P, m, b, int(bot is not None)),
                          device=dev, dtype=f32)
    blocks = backend.sm_count(dev.index or 0)
    xch = torch.empty(_wide_entry("panel_qr_wide_xch_floats", 1)(blocks),
                      device=dev, dtype=f32)
    phases = _wide_entry("panel_qr_wide_team_phases", 1, ctypes.c_int)(b)
    arrivals = torch.empty(phases * blocks, device=dev, dtype=torch.int32)
    err = _wide_kernel(sfx)(A3.data_ptr(), A3.stride(0), A3.stride(1),
                         None if bot is None else bot.data_ptr(),
                         None if rs is None else rs.data_ptr(), Y.data_ptr(),
                         T.data_ptr(), R.data_ptr(), work.data_ptr(),
                         scratch.data_ptr(), xch.data_ptr(), arrivals.data_ptr(),
                         blocks, P, m, b, backend.stream_ptr(A3))
    build.check(err, "panel_qr_wide")
    return Y, T, R


def _lanes_rs(A: torch.Tensor, row_start, op: str):
    A3 = backend.lanes(A, op)
    P, m, b = A3.shape
    if b < 1 or m < b or m * b >= 2 ** 31:
        raise ValueError(f"{op}: needs b >= 1 and m >= b, got m={m}, b={b}")
    rs = backend.to_device(row_start, A3.device).to(torch.int32)
    return A3, rs.reshape(-1).expand(P).contiguous()


def panel_qr_composed(A: torch.Tensor, row_start):
    """``panel_qr`` above MAX_B columns as separate launches
    (``wide.panel_qr_blocked``: K1's team kernel a sub-panel, K2's wide
    route between them, the T join's products of ``csrc/wide.cu``),
    counted in ``backend.SUB_LAUNCHES`` alone. The bit oracle and the time
    yardstick of the one launch; no path calls it."""
    squeeze = A.dim() == 2
    A3, rs = _lanes_rs(A, row_start, "panel_qr_composed")
    out = wide.panel_qr_blocked(A3, rs, qr=sub_qr, apply=wide.cuda_apply,
                                gemm=wide.gemm)
    return tuple(x[0] for x in out) if squeeze else out


def panel_qr(A: torch.Tensor, row_start):
    """(Y, T, R) of the masked panel QR of the CUDA tensor A, shaped
    (P, m, b) or (m, b), any b >= 1 with m >= b; ``row_start`` is a scalar
    or one value per lane. A may be a strided view (unit column stride).
    Up to MAX_B columns each lane runs on a team of
    ``backend.team_blocks(m, b)`` blocks; a wider panel runs in sub-panels
    of 128 columns inside one launch (``launch_wide``); either at f32 or
    bf16, the outputs in A's dtype."""
    squeeze = A.dim() == 2
    A3, rs = _lanes_rs(A, row_start, "panel_qr")
    if A3.shape[-1] <= MAX_B:
        Y, T, R = _launch(A3, rs)
    else:
        Y, T, R = launch_wide(A3, rs)
    backend.count_launch("panel_qr", A3.dtype)
    if squeeze:
        return Y[0], T[0], R[0]
    return Y, T, R
