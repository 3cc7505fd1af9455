"""K5: the fused per-lane leaf, and K6: the whole-panel megakernel (port of
``src/repro/kernels/fused_sweep.py``).

``fused_panel`` launches the CUDA kernel (``csrc/fused_panel.cuh``) that
runs all of panel ``k``'s sweep points (leaf QR, L butterfly levels, the
leaf apply, L trailing combines) in one cooperative launch over the
(P, m, w) window; ``fused_panel_math`` is its plain version: the
``sweep_step`` bodies concatenated over ``SimComm`` with the plain forms
of ``kernels/ref.py``, minus the panel-(k-1) deposit, which stays outside
as in the JAX package. Both give exactly the state that ``1 + 2L``
``sweep_step`` calls give (``ft/online/state.py::run_panel_fused``): the
plain version because it runs the same program, the kernel because it
computes every element with the device code of K1-K4.

``panel_qr_apply`` launches K5 (the leaf QR of ``W[..., :b]``, Q^T over
the whole window and the C' rows at ``row_start``, one launch), and
``panel_qr_apply_ref`` is its plain version, the unfused composition of
the pure forms.

Both take any panel width, at f32 and bf16. Up to 128 columns they run
the b <= 128 bodies of ``csrc/qr_common.cuh`` (``csrc/fused_panel_f32.cu``
and, on bf16 windows, ``csrc/fused_panel_bf16.cu``); above it one
cooperative launch of the wide body (``csrc/fused_wide.cuh``:
``fused_wide_kernel`` of ``csrc/fused_sweep.cu``, and on bf16 windows
``fused_wide_bf16_kernel`` of ``csrc/fused_wide_bf16.cu``) runs the
blocked routes of ``kernels/wide.py`` (``csrc/wide_qr.cuh``: K1's team on
128-column sub-panels, the products of ``csrc/wide_common.cuh`` as
grid-wide tile phases on 128 x 128 tiles), bit-equal to the stepped wide
route. A card that cannot hold a team of the launch raises; there is no
fallback to stepping. At bf16 each launch rounds where the stepped bf16
route rounds, and is bit-equal to it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import backend, build, wide
from repro_torch.kernels.ref import panel_qr_apply as panel_qr_apply_ref  # noqa: F401

# Kernel-output field order of the fused panel (the SweepState in-flight
# fields it refills; ``tops`` is computed outside the kernel, see ``_tops``).
FUSED_FIELDS = (
    "leaf_Y", "leaf_T", "R_leaf", "R_carry",
    "level_Y2", "level_T", "C_local", "C_prime",
    "Ws", "Cs_self", "Cs_buddy",
)

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

def fused_panel_math(comm, window: torch.Tensor, k: int, *, b: int,
                     m_loc_pad: int, levels: int) -> Dict[str, object]:
    """Panel ``k``'s point sequence (leaf + L tsqr + L trailing) as one
    program over ``comm`` with the plain forms: the ``sweep_step`` bodies
    concatenated, minus the deposit. The plain version of K6."""
    from repro_torch.core.caqr import panel_geometry
    from repro_torch.core.householder import StackedQR
    from repro_torch.core.trailing import _leaf_apply, trailing_combine_level
    from repro_torch.core.tsqr import DistTSQRFactors, ft_tsqr_level
    from repro_torch.kernels import ref

    col0 = k * b
    t_lane = col0 // m_loc_pad
    _c0, _t, row_start, active = panel_geometry(comm, k, b, m_loc_pad)

    # (k, leaf): the window's panel QR, active-masked
    Y, T, R = ref.lanewise(ref.panel_qr, window[..., :b], row_start=row_start)
    leaf_Y = comm.where(active, Y, torch.zeros_like(Y))
    leaf_T = comm.where(active, T, torch.zeros_like(T))
    R_leaf = comm.where(active, R, torch.zeros_like(R))

    # (k, tsqr, 0..L-1): the butterfly ladder
    def qr(R_top, R_bot):
        return StackedQR(*ref.lanewise(ref.stacked_qr, R_top, R_bot))

    carry = R_leaf
    Y2s, Ts = [], []
    for lvl in range(levels):
        carry, Y2, T2 = ft_tsqr_level(comm, carry, lvl, t_lane, t_lane, qr=qr)
        Y2s.append(Y2)
        Ts.append(T2)
    level_Y2 = torch.stack(Y2s)
    level_T = torch.stack(Ts)

    # (k, trailing, 0) prologue: the leaf apply of the live window
    dist = DistTSQRFactors(leaf_Y, leaf_T, level_Y2, level_T, R_leaf)
    C_local, C_prime = _leaf_apply(
        comm, dist, window, row_start, active=active, skip_consumed=True,
        apply=lambda Yl, Tl, C: ref.lanewise(ref.wy_apply, Yl, Tl, C))
    C_prime = comm.where(active, C_prime, torch.zeros_like(C_prime))

    # (k, trailing, 0..L-1): the combine tree
    def combine(Y2, T2, C_top, C_bot):
        return ref.lanewise(ref.stacked_apply, Y2, T2, C_top, C_bot)

    Ws, Cs_self, Cs_buddy, tops = [], [], [], []
    for lvl in range(levels):
        out = trailing_combine_level(comm, C_prime, level_Y2[lvl], level_T[lvl],
                                     lvl, t_lane, t_lane, combine=combine)
        C_prime = out.C_prime
        Ws.append(out.W)
        Cs_self.append(out.C_self)
        Cs_buddy.append(out.C_buddy)
        tops.append(out.is_top)

    return {
        "leaf_Y": leaf_Y, "leaf_T": leaf_T,
        "R_leaf": R_leaf, "R_carry": carry,
        "level_Y2": level_Y2, "level_T": level_T,
        "C_local": C_local, "C_prime": C_prime,
        "Ws": torch.stack(Ws), "Cs_self": torch.stack(Cs_self),
        "Cs_buddy": torch.stack(Cs_buddy), "tops": tuple(tops),
    }


def _tops(P: int, t_lane: int, levels: int):
    """The per-level ``is_top`` flags (CPU bool tensors, as
    ``trailing_combine_level`` makes them): they depend only on the
    geometry, so the kernel does not emit them."""
    idx = torch.arange(P, dtype=torch.int32)
    return tuple(((idx >> lvl) & 1) == ((t_lane >> lvl) & 1)
                 for lvl in range(levels))


# The library of the b <= 128 entry points at each kernel suffix.
_PANEL_LIBS = {"f32": "fused_panel_f32", "bf16": "fused_panel_bf16"}


@functools.cache
def _k5(sfx: str):
    return build.bind(_PANEL_LIBS[sfx], f"panel_qr_apply_{sfx}",
                      [_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _P])


@functools.cache
def _k6(sfx: str):
    return build.bind(_PANEL_LIBS[sfx], f"fused_panel_{sfx}",
                      [_P, _L, _L, _P, _P] + [_I] * 9 + [_P] * 17 + [_P])


# The library of the wide kernel's entry points at each kernel suffix.
_WIDE_LIBS = {"f32": "fused_sweep", "bf16": "fused_wide_bf16"}


@functools.cache
def _k5_wide(sfx: str):
    return build.bind(_WIDE_LIBS[sfx], f"panel_qr_apply_wide_{sfx}",
                      [_P, _L, _L] + [_P] * 9 + [_I, _P] + [_I] * 4 + [_P])


@functools.cache
def _k6_wide(sfx: str):
    return build.bind(_WIDE_LIBS[sfx], f"fused_panel_wide_{sfx}",
                      [_P, _L, _L, _P, _P] + [_I] * 7 + [_P] * 16 + [_P])


@functools.cache
def _entry(name: str, nargs: int, restype=ctypes.c_size_t,
           lib: str = "fused_sweep"):
    f = getattr(build.load(lib), name)
    f.argtypes, f.restype = [_I] * nargs, restype
    return f


def smem_bytes(m: int, b: int, bn: int, levels: int = 1) -> int:
    """Shared memory of one block of K5/K6 at an (m x b) panel and column
    tile bn: the largest phase's, as the kernel computes it. Above 128
    columns the wide kernel's (``levels`` 0 for K5: no stacks)."""
    if b > wide.NB:
        return _entry("fused_wide_smem_bytes", 3)(m, b, levels)
    return _entry("fused_sweep_smem_bytes", 3)(m, b, bn)


def blocks_per_sm(m: int, b: int, bn: int, levels: int = 1) -> int:
    """Blocks of K6 (above 128 columns the wide kernel, ``levels`` 0 for
    K5) an SM holds at once at that shared memory
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    n = ctypes.c_int(0)
    wide_b = b > wide.NB
    name = "fused_wide_blocks_per_sm" if wide_b else "fused_panel_blocks_per_sm"
    f = build.bind("fused_sweep" if wide_b else _PANEL_LIBS["f32"], name,
                   [_I, _I, _I, ctypes.POINTER(ctypes.c_int)])
    build.check(f(m, b, levels if wide_b else bn, ctypes.byref(n)), name)
    return n.value


def _max_team(m: int, b: int, levels: int) -> int:
    """The largest team of the launch's team phases: K1's team size of each
    128-column sub-panel of the leaf, and (K6) of the (2b x b) stacks."""
    widths = [min(wide.NB, b - c0) for c0 in range(0, b, wide.NB)]
    rows = (m, 2 * b) if levels and b > wide.NB else (m,)
    return max(backend.team_blocks(r, bj) for r in rows for bj in widths)


def _check(op: str, m: int, w: int, b: int, bn: int, levels: int,
           x: torch.Tensor) -> None:
    if b < 1 or m < b or w < b or m * max(b, w) >= 2 ** 31:
        raise ValueError(f"{op}: needs b >= 1 and m, w >= b, got "
                         f"m={m}, w={w}, b={b}")
    smem = smem_bytes(m, b, bn, levels)
    if smem > backend.SMEM_LIMIT:
        raise ValueError(f"{op}: m={m} needs {smem} bytes of shared memory, "
                         f"over {backend.SMEM_LIMIT}")
    if b > wide.NB:  # every team of the launch must fit on the card at once
        held = blocks_per_sm(m, b, bn, levels) * backend.sm_count(x.device.index or 0)
        if held < _max_team(m, b, levels):
            raise RuntimeError(f"{op}: the card holds {held} blocks of the wide "
                               f"kernel at once, fewer than a team of "
                               f"{_max_team(m, b, levels)}")


def _leaf_scratch(P: int, m: int, b: int, x: torch.Tensor, levels: int = 0):
    """(team size, global slabs, exchange slots, arrival counters, blocks
    the exchange holds) of the leaf phase: room for a block on every SM,
    the most a cooperative grid of these kernels holds. Above 128 columns
    (no one team size: None) the slabs of the largest team phase and a row
    of counters a team phase (``levels`` 0 for K5)."""
    blocks = backend.sm_count(x.device.index or 0)
    if b > wide.NB:
        C = None
        work_floats = _entry("fused_wide_work_floats", 3)(m, b, levels)
        xch_floats = _entry("fused_sweep_xch_floats", 3)(wide.NB, 1, blocks)
        counters = blocks * _entry("fused_wide_team_phases", 2, ctypes.c_int)(b, levels)
    else:
        C = backend.team_blocks(m, b)
        work_floats = _entry("fused_sweep_work_floats", 3)(m, b, C)
        xch_floats = _entry("fused_sweep_xch_floats", 3)(b, C, blocks)
        counters = blocks
    work = torch.empty(P * work_floats, device=x.device, dtype=torch.float32)
    xch = torch.empty(xch_floats, device=x.device, dtype=torch.float32)
    arrivals = torch.empty(counters, device=x.device, dtype=torch.int32)
    return C, work, xch, arrivals, blocks


def _wide_scratch(P: int, m: int, w: int, b: int, levels: int,
                  x: torch.Tensor) -> torch.Tensor:
    """The wide kernel's global scratch (the sub-panels' factors, the
    columns in flight, the products' Z and W, K6's stacks; at bf16 also the
    float copies its products run on: the window, the leaf's Y and T, a
    blocked QR's T and R, a combine's C' halves)."""
    sfx = backend.kernel_suffix(x.dtype)
    name = ("fused_wide_scratch_floats" if sfx == "f32"
            else "fused_wide_scratch_floats_bf16")
    n = _entry(name, 5, lib=_WIDE_LIBS[sfx])(P, m, w, b, levels)
    return torch.empty(n, device=x.device, dtype=torch.float32)


@functools.cache
def _gemm_in_block():
    return build.bind("fused_sweep", "fused_gemm_f32",
                      [_P, _L, _L, _L] * 6 + [_I] * 5 + [_P])


def gemm_in_block(A, B, D=None, *, sub=False, out=None, minuend=None):
    """``wide.gemm`` through K5/K6's in-block instantiation of the tile
    routine (one 128 x 128 tile a 512-thread block on its first two
    warpgroups under ``setmaxnreg``, as the wide phases run their
    products; float32 operands, which the bf16 launch's products take too,
    on float copies). For the tests, which hold it to ``wide.gemm_order``
    bit for bit; no path calls it."""
    args, (P, M, N, K), out, diff, types = wide._operands(A, B, D, out, minuend)
    if types:
        raise ValueError("fused_gemm: float32 operands only")
    if M and N:
        build.check(_gemm_in_block()(*args, P, M, N, K, int(sub),
                                     backend.stream_ptr(A)), "fused_gemm")
    return out if diff is None else (out, diff)


def panel_qr_apply(W: torch.Tensor, row_start, b: int):
    """(Y, T, R, C, C') of the fused leaf (K5) on the CUDA window W, f32
    or bf16, shaped (P, m, w) or (m, w) (a strided view with unit column
    stride is taken), the outputs in its dtype; ``row_start`` is a scalar
    or one value per lane."""
    squeeze = W.dim() == 2
    W3 = backend.lanes(W, "panel_qr_apply")
    sfx = backend.kernel_suffix(W3.dtype)
    P, m, w = W3.shape
    bn = backend.launch_bn(P, w, W3, None)
    _check("panel_qr_apply", m, w, b, bn, 0, W3)
    dev = W3.device
    rs = backend.to_device(row_start, dev).to(torch.int32)
    rs = rs.reshape(-1).expand(P).contiguous()
    Y = torch.empty(P, m, b, device=dev, dtype=W3.dtype)
    T = torch.empty(P, b, b, device=dev, dtype=W3.dtype)
    R = torch.empty_like(T)
    C = torch.empty(P, m, w, device=dev, dtype=W3.dtype)
    Cp = torch.empty(P, b, w, device=dev, dtype=W3.dtype)
    team, work, xch, arrivals, blocks = _leaf_scratch(P, m, b, W3)
    if b > wide.NB:
        scratch = _wide_scratch(P, m, w, b, 0, W3)
        err = _k5_wide(sfx)(W3.data_ptr(), W3.stride(0), W3.stride(1),
                         rs.data_ptr(), Y.data_ptr(), T.data_ptr(), R.data_ptr(),
                         C.data_ptr(), Cp.data_ptr(), work.data_ptr(),
                         xch.data_ptr(), arrivals.data_ptr(), blocks,
                         scratch.data_ptr(), P, m, w, b, backend.stream_ptr(W3))
    else:
        gram = backend.gram_scratch(P, b, W3)
        err = _k5(sfx)(W3.data_ptr(), W3.stride(0), W3.stride(1),
                       rs.data_ptr(), Y.data_ptr(), T.data_ptr(), R.data_ptr(),
                       C.data_ptr(), Cp.data_ptr(), work.data_ptr(),
                       xch.data_ptr(), arrivals.data_ptr(), backend.ptr(gram),
                       blocks, P, m, w, b, bn, team, backend.stream_ptr(W3))
    build.check(err, "panel_qr_apply")
    backend.count_launch("panel_qr_apply", W3.dtype)
    out = (Y, T, R, C, Cp)
    return tuple(x[0] for x in out) if squeeze else out


def fused_panel(window: torch.Tensor, k: int, *, b: int, m_loc_pad: int,
                levels: int) -> Dict[str, object]:
    """All of panel ``k``'s sweep points in one launch of K6 over the CUDA
    window (P, m_loc_pad, w), f32 or bf16 (a strided view with unit column
    stride, such as ``A[..., k*b:]``). Returns the
    ``FUSED_FIELDS`` outputs, in the window's dtype, and ``tops``, as
    ``fused_panel_math`` does."""
    from repro_torch.core.caqr import panel_geometry
    from repro_torch.core.comm import SimComm

    W3 = backend.lanes(window, "fused_panel")
    sfx = backend.kernel_suffix(W3.dtype)
    if window.dim() != 3:
        raise ValueError("fused_panel: expected a (P, m, w) window")
    P, m, w = W3.shape
    L = levels
    if L < 1 or P != 1 << L or m != m_loc_pad:
        raise ValueError(f"fused_panel: needs P = 2^levels >= 2 lanes of "
                         f"m_loc_pad rows, got P={P}, levels={L}, m={m}, "
                         f"m_loc_pad={m_loc_pad}")
    bn = backend.launch_bn(P, w, W3, None)
    _check("fused_panel", m, w, b, bn, L, W3)
    dev, dt = W3.device, W3.dtype
    t_lane = (k * b) // m_loc_pad
    _c0, _t, row_start, active = panel_geometry(SimComm(P), k, b, m_loc_pad)
    rs = backend.to_device(row_start, dev).to(torch.int32).contiguous()
    act = backend.to_device(active, dev).to(torch.uint8).contiguous()

    def empty(*shape):
        return torch.empty(*shape, device=dev, dtype=dt)

    out = {
        "leaf_Y": empty(P, m, b), "leaf_T": empty(P, b, b),
        "R_leaf": empty(P, b, b), "R_carry": empty(P, b, b),
        "level_Y2": empty(L, P, b, b), "level_T": empty(L, P, b, b),
        "C_local": empty(P, m, w), "C_prime": empty(P, b, w),
        "Ws": empty(L, P, b, w), "Cs_self": empty(L, P, b, w),
        "Cs_buddy": empty(L, P, b, w),
    }
    team, work, xch, arrivals, blocks = _leaf_scratch(P, m, b, W3, L)
    if b > wide.NB:
        scratch = (work, xch, arrivals, empty(max(L - 1, 1), P, b, b),
                   _wide_scratch(P, m, w, b, L, W3))
        err = _k6_wide(sfx)(W3.data_ptr(), W3.stride(0), W3.stride(1),
                         rs.data_ptr(), act.data_ptr(), P, m, w, b, L, t_lane,
                         blocks, *(out[f].data_ptr() for f in FUSED_FIELDS),
                         *(s.data_ptr() for s in scratch),
                         backend.stream_ptr(W3))
    else:
        scratch = (work, xch, arrivals, empty(max(L - 1, 1), P, b, b),
                   empty(b, w))
        gram = backend.gram_scratch(P, b, W3)
        err = _k6(sfx)(W3.data_ptr(), W3.stride(0), W3.stride(1),
                       rs.data_ptr(), act.data_ptr(), P, m, w, b, L, t_lane,
                       bn, team, blocks,
                       *(out[f].data_ptr() for f in FUSED_FIELDS),
                       *(s.data_ptr() for s in scratch), backend.ptr(gram),
                       backend.stream_ptr(W3))
    build.check(err, "fused_panel")
    backend.count_launch("fused_panel", W3.dtype)
    out["tops"] = _tops(P, t_lane, L)
    return out
