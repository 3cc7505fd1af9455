"""Drive the PyTorch/CUDA port of FT-CAQR on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. report and build: the card's name and power limit; every CUDA kernel
   built from ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. kernels: K1-K6 at the sweep's first-panel shapes against their plain
   PyTorch versions, timed with CUDA events beside the plain version and
   one PyTorch call computing the same function (K1-K4) or the stepped
   kernels doing the same work (K5: K1+K2; K6: the stepped panel); the
   check that one lane of a P-lane launch equals a launch of it alone
   (K1-K5), and that K3 gives the two lanes of a butterfly pair, which
   stack the same two R factors, equal bits; every kernel's device time
   (torch.profiler); K3's and K6's shared memory a block, and K6's blocks
   per SM; K2 and K4 also at a late panel (w = 512) and on one lane (the
   REBUILD replay), bit-equal at two column tiles, and K1 on one lane (the
   REBUILD replay) and at the last panel's row start (rs = 3968) beside
   ``torch.geqrf`` on the same rows, all timed on the device alone
   (torch.profiler) beside the events' time, which for a short kernel
   includes the host's time to issue it; each kernel's registers and
   spills from its build log; one JSON line per kernel, and one with K1's
   team (its size, shared memory, and how many teams the card holds at
   once, from cudaOccupancyMaxActiveClusters).
3. sweep: the windowed FT-CAQR sweep of a 32768 x 4096 f32 matrix over
   P = 8 lanes at panel width 128 (32 panels, 3 butterfly levels), with
   the launch counters at 0 before it; checks that K1-K4 ran, that R is
   replicated bitwise, the Gram identity, Q^T A = [R; 0] and a
   least-squares solve. Then device time by kernel over one more sweep,
   from torch.profiler.
4. fused leaf: ``householder.panel_qr_apply`` (K5) on the first panel's
   window, counters at 0 before it, bit-equal to the stepped leaf.
5. state machine + fused: the same matrix through ``run_steps`` and,
   separately, ``run_panel_fused`` over all 32 panels (K6, counters at 0
   before it; no K1-K4 launch inside), each with ``finalize``: seconds,
   launches, peak memory; both bit-equal to the sweep's R, factors and
   bundles, and to each other at every panel boundary.
6. FT driver: ``ft_caqr_sweep`` on the same matrix with four kills (an
   early leaf point, a tsqr point and a trailing point of the panel's
   root lane mid-sweep, the last panel's last trailing point), R, factors
   and bundles bit-equal to the failure-free sweep, one single-source
   event per kill, each REBUILD's seconds; and with the same lanes killed
   at the ends of those panels (the fused path's boundaries).
7. online: ``ft_caqr_sweep_online`` on the same matrix, stepped and fused
   without a death, stepped with the four kills (a ``ScriptedKiller``,
   found by the NaN sentinel), fused with the panel-end kills, and
   stepped with double-buffered segments: R, factors and bundles
   bit-equal to the failure-free (and so to the scheduled) sweep, the
   event ledgers equal to the scheduled runs'; seconds, segments,
   boundaries, poll and recovery seconds, peak memory and launches. Then
   fused under ``MDSScheme(f=2)`` with two simultaneous non-buddy deaths
   at one boundary, decoded jointly and bit-equal to failure-free, with
   the refresh seconds per boundary and the parity's bytes.
8. shrink: SHRINK after one death, scheduled (stepped) and online (fused):
   R bit-equal between the two, the Gram identity, the new world (8 slots,
   7 live, the adopter's slice doubled to 8192 rows), and K1 and K6 at
   that height against their plain versions.
9. recovery: the FT trailing update of one panel with lane 3 killed after
   level 1 and rebuilt from one buddy, bitwise equal to the clean run.
10. square: a 4096 x 4096 sweep (m_loc = 512, so the tree root walks lanes
   0-7 and lanes are consumed): fused == stepped at every panel boundary,
   both equal to ``caqr_factorize``, and a kill of a root lane recovered
   bitwise.
11. ragged: an unaligned 32000 x 4000 sweep checked by the Gram identity,
   and fused == stepped at every panel boundary.
12. spread: each full-width sweep (``caqr_factorize``, the state machine
   stepped and fused, the four-kill FT sweep, the online sweeps stepped,
   fused and double-buffered) run five times: median and min-max seconds.

The kernels line gives each kernel's launches on every path above, each
counted from 0 just before the path ran.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Needs CUDA; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core import SimComm, caqr_apply_qt, caqr_factorize, ft_tsqr  # noqa: E402
from repro_torch.core import block_row_layout, householder, panel_geometry, recovery  # noqa: E402
from repro_torch.core.lstsq import caqr_lstsq  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    FailureSchedule,
    MDSScheme,
    ScriptedKiller,
    Semantics,
    ft_caqr_sweep,
    ft_caqr_sweep_online,
    sweep_point,
)
from repro_torch.ft.online import state as sm  # noqa: E402
from repro_torch.kernels import backend, build, ops, ref  # noqa: E402
from repro_torch.kernels import fused_sweep as tfs  # noqa: E402
from repro_torch.kernels import panel_qr as tpq  # noqa: E402
from repro_torch.kernels import stacked_qr as tsa  # noqa: E402
from repro_torch.kernels import wy_apply as twy  # noqa: E402

P, M_LOC, N, B = 8, 4096, 4096, 128
L = P.bit_length() - 1
PEAK_FP32 = 67e12    # FLOP/s, H100 SXM outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, H100 SXM HBM3
GRAM_TOL = 1e-3       # relative, float64 Gram identity R^T R = A^T A
QTA_TOL = 1e-3        # relative to max |R|
LSTSQ_TOL = 1e-3      # relative to the normal-equations solution

KERNELS = {
    "panel_qr": ("src/repro_torch/csrc/panel_qr.cu",
                 "src/repro/kernels/panel_qr.py:149"),
    "wy_apply": ("src/repro_torch/csrc/wy_apply.cu",
                 "src/repro/kernels/wy_apply.py:80"),
    "stacked_qr": ("src/repro_torch/csrc/stacked_qr.cu",
                   "src/repro/kernels/stacked_qr.py:108"),
    "stacked_apply": ("src/repro_torch/csrc/stacked_qr.cu",
                      "src/repro/kernels/stacked_qr.py:171"),
    "panel_qr_apply": ("src/repro_torch/csrc/fused_sweep.cu",
                       "src/repro/kernels/fused_sweep.py:226"),
    "fused_panel": ("src/repro_torch/csrc/fused_sweep.cu",
                    "src/repro/kernels/fused_sweep.py:167"),
}
STEPPED = ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply")
LATE_W = 512  # a late panel's window width (panel 28 of 32)
# the FT driver's four kills {point: lane}: an early leaf point, a tsqr and
# a trailing point mid-sweep (the latter of the root lane: every panel of
# the tall cell is rooted at lane 0) and the last panel's last point
KILLS = {sweep_point(1, "leaf"): 2,
         sweep_point(12, "tsqr", 1): 5,
         sweep_point(16, "trailing", 0): 0,
         sweep_point(N // B - 1, "trailing", L - 1): 7}
# fused boundaries are panel ends: the same lanes at the last point of the
# same four panels
PANEL_END_KILLS = {sweep_point(k, "trailing", L - 1): lane
                   for (k, _, _), lane in KILLS.items()}
SPREAD_RUNS = 5
# launches of every kernel on every path, counters at 0 before each path
PATH_LAUNCHES = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def device_ms(fn, reps: int, kernel: str = ""):
    """Device time per call of ``fn``: the kernels' own time under
    torch.profiler over ``reps`` calls. Unlike ``time_ms`` it leaves out
    the host's time to issue each call, which bounds the eager time of a
    kernel shorter than about 0.05 ms. The trace must hold at least
    ``reps`` records of ``kernel`` (a name prefix; any kernel if empty):
    the profiler has been seen to drop records, so it tries three times,
    then gives None (not measured) rather than a short sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum(e.count for e in events
                   if e.key.removeprefix("void ").startswith(kernel))
        if seen >= reps:
            return sum(_device_us(e) for e in events) / reps / 1e3
    return None


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def max_err(got, want):
    """(largest |got - want| over all outputs, the same with each output's
    difference over max(1, max|want|)); the second is held to the
    tolerance."""
    diffs = [(float((g - w).abs().max()), max(1.0, float(w.abs().max())))
             for g, w in zip(got, want)]
    return max(d for d, _ in diffs), max(d / s for d, s in diffs)


def as_tuple(x):
    if isinstance(x, dict):
        return tuple(x[f] for f in x if f != "tops")
    return x if isinstance(x, tuple) else (x,)


def same_bits(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(as_tuple(got), as_tuple(want)))


def wy_cost(P, m, b, n):
    """(FLOPs, bytes) of K2: Y^T C and Y W at 2mbn each, T^T W1 at b^2 n
    (T triangular, counted once); Y, T, C read and out written once."""
    return (P * (4.0 * m * b * n + b * b * n),
            4.0 * P * (m * b + b * b + 2 * m * n))


def sa_cost(P, b, n):
    """(FLOPs, bytes) of K4: three triangular products at b^2 n each;
    Y2, T, Ct, Cb read and ot, ob, W written once."""
    return P * 3.0 * b * b * n, 4.0 * P * (2 * b * b + 5 * b * n)


def wy_library(Y, T, C):
    return C - Y @ (T.mT @ (Y.mT @ C))


def sa_library(Y2, T2, Ct, Cb):
    W = T2.mT @ (Ct + Y2.mT @ Cb)
    return Ct - W, Cb - Y2 @ W, W


def ptxas(source: str, kernel: str) -> dict:
    """Registers and spill bytes of every instance of ``kernel`` (a
    ``__global__`` name) in the build log of ``source``."""
    out = {}
    for fn, use in build.resource_usage(pathlib.Path(source).stem).items():
        m = re.match(r"_Z(\d+)", fn)  # the name's length, then the name
        end = m.end() + int(m.group(1)) if m else 0
        if m and fn[m.end():end] == kernel:
            # template arguments: Li128E (int 128), Lb1E (true)
            tmpl = re.match(r"I((?:L[ib]\d+E)+)E", fn[end:])
            args = [v if t == "i" else ("false", "true")[int(v)]
                    for t, v in re.findall(r"L([ib])(\d+)E",
                                           tmpl.group(1) if tmpl else "")]
            out[kernel + (f"<{', '.join(args)}>" if args else "")] = use
    return out


def leaf_cost(P, m, b, rs):
    """(FLOPs, bytes) of K1 on P panels whose column loops start at row rs:
    3 m' b^2 - b^3 / 3 a lane over the m' = m - rs rows the loop touches;
    those rows read, Y (m x b), T and R written once."""
    ma = m - rs
    return (P * (3.0 * ma * b * b - b ** 3 / 3.0),
            4.0 * P * (ma * b + m * b + 2 * b * b))


def k1_record(panel: torch.Tensor, rs: int, reps: int) -> dict:
    """K1 on one lane's (m x b) panel at row start rs, beside the plain
    version and ``torch.geqrf`` of the rows the column loop touches."""
    m, b = panel.shape
    run = lambda: ops.panel_qr(panel, rs)  # noqa: E731
    active = panel[rs:].contiguous()
    lib = lambda: torch.geqrf(active)  # noqa: E731
    err, scaled = max_err(run(), ref.panel_qr(panel, rs))
    check(scaled <= ref.tolerances(torch.float32)[0],
          f"panel_qr: scaled error {scaled} at rs = {rs}")
    bms, by = bound_ms(*leaf_cost(1, m, b, rs))
    return dict(shape=[m, b], row_start=rs, team=backend.team_blocks(m, b),
                max_abs_err=err, scaled_err=scaled, ms=time_ms(run, reps),
                device_ms=device_ms(run, reps, "panel_qr_kernel"),
                bound_ms=bms, bound_by=by,
                library_ms=time_ms(lib, reps),
                library_device_ms=device_ms(lib, reps),
                library_shape=list(active.shape))


def team_record() -> dict:
    """K1's lane team at the tall and square cells' panels: its size,
    shared memory a block, and how many teams the card holds at once; the
    registers and spills of K1, K5 and K6 from their build logs."""
    out = {}
    for cell, m in (("tall", M_LOC), ("square", N // P)):
        C = backend.team_blocks(m, B)
        out[cell] = dict(m=m, b=B, team=C,
                         slab_in_smem=backend.team_slab_in_smem(m, B, C),
                         smem_bytes=tpq.smem_bytes(m, B, C),
                         max_active_clusters=tpq.max_active_clusters(m, B))
    out["ptxas"] = {**ptxas(KERNELS["panel_qr"][0], "panel_qr_kernel"),
                    **ptxas(KERNELS["fused_panel"][0], "panel_qr_apply_kernel"),
                    **ptxas(KERNELS["fused_panel"][0], "fused_panel_kernel")}
    return out


def shape_record(op: str, args: tuple, cost: tuple, lib, reps: int) -> dict:
    """One kernel at other shapes than the first panel's: time, bound,
    library time and error against the plain version."""
    run = getattr(ops, op)
    got, want = as_tuple(run(*args)), as_tuple(getattr(ref, op)(*args))
    err, scaled = max_err(got, want)
    del got, want
    check(scaled <= ref.tolerances(torch.float32)[0],
          f"{op}: scaled error {scaled} at {[tuple(a.shape) for a in args]}")
    bms, by = bound_ms(*cost)
    C = args[2]
    P = C.shape[0] if C.dim() == 3 else 1
    return dict(shapes=[list(a.shape) for a in args], bn=backend.tile_bn(
        P, C.shape[-1], backend.sm_count(0)),
        max_abs_err=err, scaled_err=scaled, ms=time_ms(lambda: run(*args), reps),
        device_ms=device_ms(lambda: run(*args), reps, op + "_kernel"),
        bound_ms=bms, bound_by=by, library_ms=time_ms(lambda: lib(*args), reps),
        library_device_ms=device_ms(lambda: lib(*args), reps))


def kernel_phase(A: torch.Tensor) -> list:
    """K1-K6 on the first panel's data of the sweep, against their plain
    versions; returns one record per kernel."""
    rtol, _ = ref.tolerances(torch.float32)
    f = 4.0  # bytes per float
    panel = A[..., :B].contiguous()
    rows = [(i, i ^ 1) for i in range(P)]
    C = A  # panel 0's live window is the whole width
    comm = SimComm(P)
    cases = {}
    Y, T, R = ops.panel_qr(panel, 0)
    leaf_flops = 3.0 * M_LOC * B * B - B ** 3 / 3.0
    apply_flops = 4.0 * M_LOC * B * N + B * B * N
    flops, nbytes = leaf_cost(P, M_LOC, B, 0)
    cases["panel_qr"] = dict(
        run=lambda: ops.panel_qr(panel, 0), plain=lambda: ref.panel_qr(panel, 0),
        lib=lambda: torch.geqrf(panel), flops=flops, nbytes=nbytes, reps=20)
    flops, nbytes = wy_cost(P, M_LOC, B, N)
    cases["wy_apply"] = dict(
        run=lambda: ops.wy_apply(Y, T, C), plain=lambda: ref.wy_apply(Y, T, C),
        lib=lambda: wy_library(Y, T, C), flops=flops, nbytes=nbytes, reps=10)
    R_top = R.contiguous()
    R_bot = R[[j for _, j in rows]].contiguous()
    Y2, T2, _ = ops.stacked_qr(R_top, R_bot)
    stack = torch.cat([R_top, R_bot], dim=1)
    cases["stacked_qr"] = dict(
        run=lambda: ops.stacked_qr(R_top, R_bot),
        plain=lambda: ref.stacked_qr(R_top, R_bot),
        lib=lambda: torch.geqrf(stack),
        flops=P * float(B ** 3), nbytes=f * P * 5 * B * B, reps=10)
    Ct = ops.wy_apply(Y, T, C)[:, :B].contiguous()
    Cb = Ct[[j for _, j in rows]].contiguous()
    flops, nbytes = sa_cost(P, B, N)
    cases["stacked_apply"] = dict(
        run=lambda: ops.stacked_apply(Y2, T2, Ct, Cb),
        plain=lambda: ref.stacked_apply(Y2, T2, Ct, Cb),
        lib=lambda: sa_library(Y2, T2, Ct, Cb), flops=flops, nbytes=nbytes,
        reps=10)

    def k1_k2():
        Yl, Tl, _ = ops.panel_qr(A[..., :B], 0)
        return ops.wy_apply(Yl, Tl, A)

    cases["panel_qr_apply"] = dict(
        run=lambda: ops.panel_qr_apply(A, 0, B),
        plain=lambda: ref.panel_qr_apply(A, 0, B),
        stepped=k1_k2, stepped_route="K1+K2 (panel_qr, wy_apply)",
        flops=P * (leaf_flops + apply_flops),
        nbytes=f * P * (2 * M_LOC * N + M_LOC * B + 2 * B * B + B * N),
        reps=3)
    s0 = sm.initial_sweep_state(comm, A, B)
    pts = sm.panel_points(s0.geom)
    cases["fused_panel"] = dict(
        run=lambda: ops.fused_panel(A, 0, b=B, m_loc_pad=M_LOC, levels=L),
        plain=lambda: ref.fused_panel(A, 0, b=B, m_loc_pad=M_LOC, levels=L),
        stepped=lambda: sm.run_steps(comm, s0, pts),
        stepped_route="the stepped panel (K1, 3 x K3, K2, 3 x K4)",
        flops=P * (leaf_flops + apply_flops + L * (B ** 3 + 3.0 * B * B * N)),
        nbytes=f * P * (2 * M_LOC * N + M_LOC * B + (3 + 2 * L) * B * B
                        + (1 + 3 * L) * B * N),
        reps=3)

    # Determinism: one lane of the P-lane launch equals a launch of it alone.
    k = P - 3
    check(same_bits(tuple(x[k] for x in (Y, T, R)), ops.panel_qr(panel[k], 0)),
          "panel_qr: lane bits depend on the launch")
    one = ops.stacked_qr(R_top[k], R_bot[k])
    check(all(torch.equal(a[k], o) for a, o in
              zip(ops.stacked_qr(R_top, R_bot), one)),
          "stacked_qr: lane bits depend on the launch")
    # K3 on a butterfly pair's stacks, as ft_tsqr_level gives them at level
    # 0: both lanes of a pair stack the same two R factors, top lane first.
    pair = ops.stacked_qr(R[[p & ~1 for p in range(P)]].contiguous(),
                          R[[p | 1 for p in range(P)]].contiguous())
    pair_bitwise = all(torch.equal(x[p], x[p ^ 1]) for x in pair for p in range(P))
    check(pair_bitwise, "stacked_qr: the two lanes of a butterfly pair differ")
    del pair
    one = ops.wy_apply(Y[k], T[k], C[k])
    check(torch.equal(ops.wy_apply(Y, T, C)[k], one),
          "wy_apply: lane bits depend on the launch")
    one = ops.stacked_apply(Y2[k], T2[k], Ct[k], Cb[k])
    check(all(torch.equal(a[k], o) for a, o in
              zip(ops.stacked_apply(Y2, T2, Ct, Cb), one)),
          "stacked_apply: lane bits depend on the launch")
    fused_leaf = ops.panel_qr_apply(A, 0, B)
    check(same_bits(tuple(x[k] for x in fused_leaf),
                    ops.panel_qr_apply(A[k], 0, B)),
          "panel_qr_apply: lane bits depend on the launch")
    # K5 shares K1's and K2's device code: bit-equal to the two launches.
    Yk, Tk, Rk = ops.panel_qr(A[..., :B], 0)
    Ck = ops.wy_apply(Yk, Tk, A)
    check(same_bits(fused_leaf, (Yk, Tk, Rk, Ck, Ck[:, :B])),
          "panel_qr_apply differs from panel_qr then wy_apply")
    del fused_leaf, Yk, Tk, Rk, Ck
    # K2 and K4: the column tile does not change the bits.
    bn_bitwise = {
        "wy_apply": same_bits(twy.wy_apply(Y, T, C, bn=32),
                              twy.wy_apply(Y, T, C, bn=128)),
        "stacked_apply": same_bits(tsa.stacked_apply(Y2, T2, Ct, Cb, bn=32),
                                   tsa.stacked_apply(Y2, T2, Ct, Cb, bn=128)),
    }
    check(all(bn_bitwise.values()), f"column tiles change the bits: {bn_bitwise}")
    # K2 and K4 at a late panel's window and on one lane (a REBUILD replay)
    late = N - LATE_W
    Ctl, Cbl = Ct[..., :LATE_W].contiguous(), Cb[..., :LATE_W].contiguous()
    other_shapes = {
        "panel_qr": {
            "one_lane": k1_record(panel[k], 0, 20),
            "late_panel": k1_record(panel[0], M_LOC - B, 50)},
        "wy_apply": {
            "late_panel": shape_record("wy_apply", (Y, T, A[..., late:]),
                                       wy_cost(P, M_LOC, B, LATE_W), wy_library, 20),
            "one_lane": shape_record("wy_apply", (Y[k], T[k], A[k]),
                                     wy_cost(1, M_LOC, B, N), wy_library, 20)},
        "stacked_apply": {
            "late_panel": shape_record("stacked_apply", (Y2, T2, Ctl, Cbl),
                                       sa_cost(P, B, LATE_W), sa_library, 50),
            "one_lane": shape_record("stacked_apply", (Y2[k], T2[k], Ct[k], Cb[k]),
                                     sa_cost(1, B, N), sa_library, 50)},
    }
    del Ctl, Cbl

    records = []
    for name, c in cases.items():
        got, want = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        err, scaled = max_err(as_tuple(got), as_tuple(want))
        del got, want
        check(scaled <= rtol, f"{name}: scaled error {scaled} over tolerance {rtol}")
        ms = time_ms(c["run"], c["reps"])
        slow_plain = name in ("panel_qr", "panel_qr_apply", "fused_panel")
        plain_ms = time_ms(c["plain"], 1 if slow_plain else c["reps"])
        bms, by = bound_ms(c["flops"], c["nbytes"])
        source, replaces = KERNELS[name]
        rec = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err, scaled_err=scaled,
                   tolerance=rtol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by,
                   library_ms=time_ms(c["lib"], c["reps"]) if "lib" in c else None)
        rec["device_ms"] = device_ms(c["run"], c["reps"], name + "_kernel")
        if "lib" in c:
            rec["library_device_ms"] = device_ms(c["lib"], c["reps"])
        if "stepped" in c:
            # no single PyTorch call computes K5 or K6: the yardstick is the
            # stepped kernels doing the same work
            rec["stepped_ms"] = time_ms(c["stepped"], c["reps"])
            rec["stepped_route"] = c["stepped_route"]
        if name == "stacked_qr":
            rec["smem_bytes"] = tsa.smem_bytes(B)
            rec["pair_bitwise"] = pair_bitwise
        if name == "fused_panel":
            bn = backend.tile_bn(P, N, backend.sm_count(0))
            rec["smem_bytes"] = tfs.smem_bytes(M_LOC, B, bn)
            rec["blocks_per_sm"] = tfs.blocks_per_sm(M_LOC, B, bn)
        if name in other_shapes:
            if name in bn_bitwise:
                rec["bn"] = backend.tile_bn(P, N, backend.sm_count(0))
                rec["bn_bitwise"] = bn_bitwise[name]
            rec.update(other_shapes[name])
        rec["ptxas"] = ptxas(source, name + "_kernel")
        emit({"kernel": rec})
        records.append(rec)
    return records


def gram_error(A_flat64: torch.Tensor, R: torch.Tensor) -> float:
    G = A_flat64.T @ A_flat64
    R64 = R.double()
    return float((R64.T @ R64 - G).abs().max() / G.abs().max())


def sweep_phase(A: torch.Tensor, rng):
    """The slice-1 main path, launch counters at 0 before it; returns the
    launches, the sweep's seconds and its (R, factors, bundles)."""
    comm = SimComm(P)
    backend.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = caqr_factorize(A, comm, B, use_scan=False, collect_bundles=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(backend.LAUNCHES)
    check(all(launches[op] > 0 for op in STEPPED),
          f"a kernel was not launched by the sweep: {launches}")
    check(bool((res.R == res.R[:1]).all()), "R is not replicated bitwise")
    m = P * M_LOC
    flops = 2.0 * m * N * N - 2.0 * N ** 3 / 3.0
    A64 = A.reshape(-1, N).double()
    R0 = res.R[0]
    gram = gram_error(A64, R0)
    check(gram <= GRAM_TOL, f"Gram identity: {gram} > {GRAM_TOL}")
    QtA = caqr_apply_qt(A, res.factors, comm).reshape(-1, N)
    rmax = float(R0.abs().max())
    top = float((QtA[:N] - R0).abs().max()) / rmax
    rest = float(QtA[N:].abs().max()) / rmax
    del QtA
    check(max(top, rest) <= QTA_TOL, f"Q^T A != [R; 0]: {top}, {rest}")
    rhs = block_row_layout(rng.standard_normal((m, 1)).astype(np.float32), P)
    x = caqr_lstsq(A, rhs, comm, B, result=res._replace(bundles=None)).double()
    b64 = rhs.reshape(-1, 1).double()
    x_ne = torch.linalg.solve(A64.T @ A64, A64.T @ b64)
    lst = float((x - x_ne).norm() / x_ne.norm())
    check(lst <= LSTSQ_TOL, f"lstsq vs normal equations: {lst}")
    out = dict(shape=[m, N], P=P, b=B, panels=N // B, levels=L,
               seconds=seconds, gflops=flops / seconds / 1e9,
               launches=launches, gram_rel_err=gram, qta_top_rel_err=top,
               qta_rest_rel=rest, lstsq_rel_err=lst,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"sweep": out})
    PATH_LAUNCHES["sweep"] = dict(launches)
    return launches, seconds, res


def profile_phase(A: torch.Tensor, sweep_seconds: float) -> None:
    """Device time by kernel over the same sweep run once more under
    torch.profiler: where the sweep's time goes. The tracer slows the host
    several-fold, so the busy share is taken against the unprofiled
    sweep's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        caqr_factorize(A, SimComm(P), B, use_scan=False, collect_bundles=True)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {name: 0.0 for name in STEPPED}
    other = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(e)
        key = e.key.removeprefix("void ")  # templated kernels carry it
        name = next((k for k in STEPPED if key.startswith(k + "_kernel")), None)
        if name is None:
            other += us / 1e3
        else:
            by_kernel[name] += us / 1e3
    busy = sum(by_kernel.values()) + other
    emit({"profile": dict(profiled_wall_ms=wall_ms, kernel_ms=by_kernel,
                          other_device_ms=other, device_ms=busy,
                          device_busy_share=busy / (sweep_seconds * 1e3))})


def fused_leaf_phase(A: torch.Tensor) -> dict:
    """K5's path: the fused leaf entry point on the first panel's window,
    counters at 0 before it; bit-equal to the stepped leaf (K1 then K2)."""
    comm = SimComm(P)
    _c0, _t, row_start, _act = panel_geometry(comm, 0, B, M_LOC)
    backend.reset_launches()
    wy, C, Cp = householder.panel_qr_apply(A, row_start, B)
    torch.cuda.synchronize()
    launches = dict(backend.LAUNCHES)
    wy1 = householder.householder_qr_masked(A[..., :B], row_start)
    C1 = householder.apply_qt(wy1.Y, wy1.T, A)
    same = same_bits((*wy, C, Cp), (*wy1, C1, C1[:, :B]))
    emit({"fused_leaf": dict(window=list(A.shape), launches=launches,
                             bitwise_equal_stepped=same)})
    PATH_LAUNCHES["fused_leaf"] = launches
    check(launches["panel_qr_apply"] == 1 and
          all(launches[op] == 0 for op in STEPPED),
          f"fused leaf launches: {launches}")
    check(same, "fused leaf differs from the stepped leaf")
    return launches


def states_equal(a: sm.SweepState, b: sm.SweepState) -> bool:
    fa, fb = sm.flat_arrays(a), sm.flat_arrays(b)
    return (a.cursor == b.cursor and fa.keys() == fb.keys()
            and all(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
                    for k in fa))


def lockstep(A: torch.Tensor) -> int:
    """Fused and stepped sweeps side by side; checks the states bit for bit
    at every panel boundary and the finalized outputs; returns the number
    of boundaries compared."""
    comm = SimComm(P)
    s_f = s_s = sm.initial_sweep_state(comm, A, B)
    pts = sm.panel_points(s_s.geom)
    n = 0
    while s_f.cursor is not None:
        s_f = sm.run_panel_fused(comm, s_f)
        s_s = sm.run_steps(comm, s_s, pts)
        check(states_equal(s_f, s_s),
              f"fused state differs from stepped at boundary {s_s.cursor}")
        n += 1
    check(same_bits(flat_result(sm.finalize(comm, s_f)),
                    flat_result(sm.finalize(comm, s_s))),
          "fused and stepped finalize differ")
    return n


def flat_result(res) -> tuple:
    R, factors, bundles = res[:3]
    return (R, *factors, *bundles)


def timed_sweep(A: torch.Tensor, fused: bool):
    """One state-machine sweep to completion with finalize, counters and
    peak memory reset before it; returns (result, seconds, launches, GB):
    the peak is counted above what was allocated before the sweep."""
    comm = SimComm(P)
    s = sm.initial_sweep_state(comm, A, B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    t0 = time.perf_counter()
    if fused:
        while s.cursor is not None:
            s = sm.run_panel_fused(comm, s)
    else:
        s = sm.run_steps(comm, s)
    out = sm.finalize(comm, s)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del s
    return (out, seconds, dict(backend.LAUNCHES),
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def state_machine_phase(A: torch.Tensor, want: tuple) -> dict:
    """K6's path: the full-width sweep stepped and fused, each alone
    (seconds, launches, peak memory) and bit-equal to the sweep's
    outputs, then side by side, equal at every panel boundary."""
    res_s, sec_s, launch_s, mem_s = timed_sweep(A, fused=False)
    ok_s = same_bits(flat_result(res_s), want)
    del res_s
    res_f, sec_f, launch_f, mem_f = timed_sweep(A, fused=True)
    ok_f = same_bits(flat_result(res_f), want)
    del res_f
    boundaries = lockstep(A)
    PATH_LAUNCHES["state_machine_stepped"] = launch_s
    PATH_LAUNCHES["state_machine_fused"] = launch_f
    emit({"state_machine": dict(
        shape=[P * M_LOC, N], stepped_seconds=sec_s, fused_seconds=sec_f,
        stepped_launches=launch_s, fused_launches=launch_f,
        stepped_peak_mem_gb_above_live=mem_s,
        fused_peak_mem_gb_above_live=mem_f,
        stepped_equals_sweep=ok_s, fused_equals_sweep=ok_f,
        boundaries_bitwise=boundaries)})
    check(ok_s, "stepped state machine differs from caqr_factorize")
    check(ok_f, "fused sweep differs from caqr_factorize")
    check(launch_f["fused_panel"] == N // B and
          all(launch_f[op] == 0 for op in STEPPED),
          f"fused sweep launches: {launch_f}")
    check(all(launch_s[op] > 0 for op in STEPPED) and
          launch_s["fused_panel"] == 0, f"stepped launches: {launch_s}")
    return launch_f


def kill_check(A: torch.Tensor, comm, kills: dict, want: tuple) -> dict:
    """ft_caqr_sweep under ``kills`` ({point: lane}); bit-equal to
    ``want``, one single-source event per kill."""
    sched = FailureSchedule(events={pt: [lane] for pt, lane in kills.items()})
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    got = ft_caqr_sweep(A, comm, B, schedule=sched)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    same = same_bits(flat_result(got), want)
    events = [dict(point=list(e.point), lane=e.lane, reads=e.reads,
                   rebuild_seconds=e.elapsed_s) for e in got.events]
    check([(tuple(e["point"]), e["lane"]) for e in events] == list(kills.items()),
          f"events {events} do not match the kills {kills}")
    check(all(e["lane"] not in e["reads"].values() for e in events),
          "a rebuild read from the dead lane")
    check(same, "the FT sweep with kills differs from the failure-free sweep")
    return dict(seconds=seconds, events=events, bitwise_equal=same,
                launches=dict(backend.LAUNCHES), ledger=ledger(got.events))


def ledger(events) -> list:
    """(point, lane, reads) of each RecoveryEvent."""
    return [(tuple(e.point), e.lane, dict(e.reads)) for e in events]


def ft_driver_phase(A: torch.Tensor, want: tuple) -> dict:
    """The scheduled FT sweep with the four kills and, for the fused online
    run, with the same lanes killed at those panels' ends; returns both
    event ledgers."""
    out = kill_check(A, SimComm(P), KILLS, want)
    ends = kill_check(A, SimComm(P), PANEL_END_KILLS, want)
    PATH_LAUNCHES["ft_driver"] = out["launches"]
    ledgers = {"kills": out.pop("ledger"),
               "panel_end_kills": ends.pop("ledger")}
    emit({"ft_driver": dict(shape=[P * M_LOC, N], **out,
                            panel_end_kills=dict(
                                seconds=ends["seconds"],
                                events=ends["events"]))})
    return ledgers


class TimedScheme:
    """A coding scheme that times each ``refresh`` (the device synchronised
    before and after) and records the parity's bytes; everything else is
    the wrapped scheme's."""

    def __init__(self, inner):
        self.inner = inner
        self.name, self.f, self.joint = inner.name, inner.f, inner.joint
        self.seconds = []
        self.parity_bytes = 0

    def refresh(self, comm, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner.refresh(comm, state)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.parity_bytes = max(self.parity_bytes,
                                sum(c.numel() for c in out.code))
        return out

    def decode_lanes(self, comm, state, newly, dead):
        return self.inner.decode_lanes(comm, state, newly, dead)


def online_run(A: torch.Tensor, kills: dict, **kw):
    """``ft_caqr_sweep_online`` on the tall cell with a ``ScriptedKiller``
    at ``kills`` ({point: [lanes]}), launch counters at 0 just before it
    and peak memory counted above what was live; returns (result, the
    orchestrator's statistics, seconds, launches, peak GB)."""
    seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    t0 = time.perf_counter()
    res = ft_caqr_sweep_online(
        A, SimComm(P), B, fault_hooks=[ScriptedKiller(kills)],
        boundary_hooks=[lambda orch: seen.append(orch)], **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    orch = seen[-1]
    stats = dict(seconds=seconds, segments_run=orch.segments_run,
                 boundaries=orch.boundaries, poll_s=orch.poll_s,
                 recover_s=orch.recover_s,
                 peak_mem_gb_above_live=(torch.cuda.max_memory_allocated()
                                         - base) / 1e9)
    return res, stats, dict(backend.LAUNCHES)


def online_phase(A: torch.Tensor, want: tuple, ledgers: dict) -> None:
    """The online path on the tall cell: stepped and fused without a
    death; stepped with the FT driver's four kills, fused with the same
    lanes killed at those panels' ends, and stepped with double-buffered
    segments; each bit-equal to the failure-free sweep (so to the
    scheduled runs, which equal it too) with the scheduled run's event
    ledger. Then fused under MDSScheme(f=2) with
    two simultaneous non-buddy deaths at one boundary, decoded jointly."""
    kills = {pt: [lane] for pt, lane in KILLS.items()}
    ends = {pt: [lane] for pt, lane in PANEL_END_KILLS.items()}
    out = {}
    for path, k, led, kw in (
            ("online_stepped_failure_free", {}, [], {}),
            ("online_fused_failure_free", {}, [], dict(fused=True)),
            ("online_stepped", kills, ledgers["kills"], {}),
            ("online_fused", ends, ledgers["panel_end_kills"], dict(fused=True)),
            ("online_async", kills, ledgers["kills"],
             dict(async_segments=True))):
        res, stats, launches = online_run(A, k, **kw)
        same = same_bits(flat_result(res), want)
        got_ledger = ledger(res.events)
        del res
        PATH_LAUNCHES[path] = launches
        out[path] = dict(stats, bitwise_equal_scheduled=same,
                         ledger_equal_scheduled=got_ledger == led,
                         launches=launches)
        check(same, f"{path}: differs from the scheduled sweep")
        check(got_ledger == led, f"{path}: ledger {got_ledger} != {led}")
        if kw.get("fused"):
            check(launches["fused_panel"] == N // B and
                  (k or all(launches[op] == 0 for op in STEPPED)),
                  f"{path}: K6 launches {launches}")
        else:
            check(all(launches[op] > 0 for op in STEPPED)
                  and launches["fused_panel"] == 0,
                  f"{path}: launches {launches}")
    emit({"online": dict(shape=[P * M_LOC, N], **out)})

    pair = [2, 5]  # no butterfly level pairs them
    point = sweep_point(20, "trailing", L - 1)
    scheme = TimedScheme(MDSScheme(f=2))
    res, stats, launches = online_run(A, {point: pair}, fused=True,
                                      scheme=scheme)
    same = same_bits(flat_result(res), want)
    events = [dict(point=list(e.point), lane=e.lane, reads=e.reads,
                   decode_seconds=e.elapsed_s) for e in res.events]
    del res
    PATH_LAUNCHES["online_mds"] = launches
    sec = sorted(scheme.seconds)
    emit({"online_mds": dict(
        f=2, killed=pair, point=list(point), **stats,
        refresh_seconds_median=sec[len(sec) // 2],
        refresh_seconds_min=sec[0], refresh_seconds_max=sec[-1],
        refreshes=len(sec), parity_bytes_max=scheme.parity_bytes,
        events=events, bitwise_equal_failure_free=same, launches=launches)})
    check(same, "MDS joint decode differs from the failure-free sweep")
    check([e["lane"] for e in events] == pair and
          all(e["reads"].get("coded.parity1") == P + 1 for e in events),
          f"MDS events are not a joint decode: {events}")
    check(launches["fused_panel"] == N // B, f"online_mds launches {launches}")


def shrunk_kernel_check(device, m: int, w: int) -> dict:
    """K1 and K6 at the shrunken world's padded lane height against their
    plain versions (random data from a seeded generator), and their
    times."""
    g = torch.Generator().manual_seed(1)
    X = torch.randn(P, m, w, generator=g).to(device)
    tol = ref.tolerances(torch.float32)[0]
    out = {}
    for name, run, plain in (
            ("panel_qr", lambda: ops.panel_qr(X[..., :B].contiguous(), 0),
             lambda: ref.panel_qr(X[..., :B].contiguous(), 0)),
            ("fused_panel",
             lambda: ops.fused_panel(X, 0, b=B, m_loc_pad=m, levels=L),
             lambda: ref.fused_panel(X, 0, b=B, m_loc_pad=m, levels=L))):
        err, scaled = max_err(as_tuple(run()), as_tuple(plain()))
        check(scaled <= tol, f"{name} at m = {m}: scaled error {scaled}")
        C = backend.team_blocks(m, B)
        out[name] = dict(shape=[P, m, w], max_abs_err=err, scaled_err=scaled,
                         team=C, slab_in_smem=backend.team_slab_in_smem(m, B, C),
                         ms=time_ms(run, 5))
    return out


def shrink_phase(A: torch.Tensor) -> None:
    """SHRINK after one death: the scheduled elastic sweep (stepped) and
    the same kill online (fused), R bit-equal between the two and the Gram
    identity within GRAM_TOL. With P = 8 and one death under the "pad"
    policy the new world keeps 8 slots and the adopter's slice doubles, so
    the next epoch runs at m_loc_pad = 2 M_LOC."""
    lane, point = 3, sweep_point(8, "trailing", L - 1)
    backend.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = ft_caqr_sweep(A, SimComm(P), B, semantics=Semantics.SHRINK,
                          schedule=FailureSchedule(events={point: [lane]}))
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    PATH_LAUNCHES["shrink_scheduled"] = dict(backend.LAUNCHES)
    res, stats, launches = online_run(A, {point: [lane]}, fused=True,
                                      semantics=Semantics.SHRINK)
    PATH_LAUNCHES["shrink_online"] = launches
    same = torch.equal(sched.R, res.R)
    gram = gram_error(A.reshape(-1, N).double(), res.R)
    (t,) = res.transitions
    emit({"shrink": dict(
        killed=lane, point=list(point), scheduled_seconds=sched_s,
        online=stats, R_bitwise_scheduled_online=same,
        transitions_equal=sched.transitions == res.transitions,
        ledger_equal=ledger(sched.events) == ledger(res.events),
        frontier=t.frontier, adopter=t.adopter,
        world_after=dict(n_slots=t.world_after.n_slots,
                         live=list(t.world_after.live)),
        gram_rel_err=gram, launches_scheduled=PATH_LAUNCHES["shrink_scheduled"],
        launches_online=launches,
        shrunk_kernels=shrunk_kernel_check(A.device, 2 * M_LOC, N - 9 * B))})
    check(same, "SHRINK: online R differs from the scheduled R")
    check(sched.transitions == res.transitions and
          ledger(sched.events) == ledger(res.events),
          "SHRINK: transitions or ledgers differ")
    check(t.world_after.n_slots == P and t.world_after.n_live == P - 1,
          f"SHRINK world {t.world_after}")
    check(gram <= GRAM_TOL, f"SHRINK Gram identity: {gram} > {GRAM_TOL}")
    check(launches["fused_panel"] == N // B,
          f"SHRINK online K6 launches {launches}")


def spread_phase(A: torch.Tensor) -> None:
    """Run-to-run spread: every full-width sweep SPREAD_RUNS times, each
    run ending in a synchronise; median and min-max seconds."""
    comm = SimComm(P)
    kills = {pt: [lane] for pt, lane in KILLS.items()}
    ends = {pt: [lane] for pt, lane in PANEL_END_KILLS.items()}

    def fused():
        s = sm.initial_sweep_state(comm, A, B)
        while s.cursor is not None:
            s = sm.run_panel_fused(comm, s)
        return sm.finalize(comm, s)

    def online(k, **kw):
        return lambda: ft_caqr_sweep_online(
            A, comm, B, fault_hooks=[ScriptedKiller(k)], **kw)

    sweeps = {
        "caqr_factorize": lambda: caqr_factorize(
            A, comm, B, use_scan=False, collect_bundles=True),
        "state_machine_stepped": lambda: sm.finalize(
            comm, sm.run_steps(comm, sm.initial_sweep_state(comm, A, B))),
        "state_machine_fused": fused,
        "ft_sweep_four_kills": lambda: ft_caqr_sweep(
            A, comm, B, schedule=FailureSchedule(events=kills)),
        "online_stepped_four_kills": online(kills),
        "online_fused_four_kills": online(ends, fused=True),
        "online_async_four_kills": online(kills, async_segments=True),
    }
    out = {}
    for name, fn in sweeps.items():
        times = []
        for _ in range(SPREAD_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del res
        times.sort()
        out[name] = dict(median_s=times[len(times) // 2], min_s=times[0],
                         max_s=times[-1], runs=times)
    emit({"spread": dict(shape=[P * M_LOC, N], runs=SPREAD_RUNS, **out)})


def recovery_phase(A: torch.Tensor) -> None:
    comm = SimComm(P)
    backend.reset_launches()
    fac = ft_tsqr(A[..., :B], comm)
    C = A[..., B:]
    clean = recovery.run_ft_trailing(C, fac, comm)
    faulty = recovery.run_ft_trailing(C, fac, comm, fail_at_level=1,
                                      failed_lane=3, A_stacked=C)
    torch.cuda.synchronize()
    same = torch.equal(clean, faulty)
    emit({"recovery": dict(panel=[P, M_LOC, B], trailing=list(C.shape),
                           killed_lane=3, after_level=1, bitwise_equal=same,
                           launches=dict(backend.LAUNCHES))})
    check(same, "recovered run differs from the clean run")


def square_phase(rng) -> None:
    """4096 x 4096 over P = 8 (m_loc = 512): the root walks lanes 0-7,
    consumed lanes and row_start clamping past lane 0 occur."""
    n = N
    m_loc = n // P
    A = block_row_layout(rng.standard_normal((n, n)).astype(np.float32), P)
    comm = SimComm(P)
    ref_res = caqr_factorize(A, comm, B, use_scan=False, collect_bundles=True)
    want = flat_result(ref_res)
    gram = gram_error(A.reshape(-1, n).double(), ref_res.R[0])
    check(gram <= GRAM_TOL, f"square Gram identity: {gram} > {GRAM_TOL}")
    boundaries = lockstep(A)
    k = 13                     # col0 = 1664: rooted at lane 3
    root = (k * B) // m_loc
    out = kill_check(A, comm, {sweep_point(k, "trailing", 1): root}, want)
    del out["ledger"]
    emit({"square": dict(shape=[n, n], m_loc=m_loc, gram_rel_err=gram,
                         boundaries_bitwise=boundaries, kill=out)})


def ragged_phase(rng) -> None:
    m_loc, n = 4000, 4000
    A_np = rng.standard_normal((P * m_loc, n)).astype(np.float32)
    A = block_row_layout(A_np, P)
    res = caqr_factorize(A, SimComm(P), B, use_scan=False)
    torch.cuda.synchronize()
    check(tuple(res.R.shape) == (P, n, n), f"ragged R shape {res.R.shape}")
    gram = gram_error(A.reshape(-1, n).double(), res.R[0])
    check(gram <= GRAM_TOL, f"ragged Gram identity: {gram} > {GRAM_TOL}")
    del res
    boundaries = lockstep(A)
    emit({"ragged": dict(m_loc=m_loc, n=n, b=B, gram_rel_err=gram,
                         fused_boundaries_bitwise=boundaries)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    emit({"build_seconds": time.perf_counter() - t0, "card": card})

    rng = np.random.default_rng(args.seed)
    A = block_row_layout(rng.standard_normal((P * M_LOC, N)).astype(np.float32), P)
    emit({"team": team_record()})
    records = kernel_phase(A)
    launches, sweep_seconds, res = sweep_phase(A, rng)
    want = flat_result(res)
    del res
    profile_phase(A, sweep_seconds)
    launches.update({"panel_qr_apply": fused_leaf_phase(A)["panel_qr_apply"]})
    launches.update({"fused_panel": state_machine_phase(A, want)["fused_panel"]})
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    ledgers = ft_driver_phase(A, want)
    online_phase(A, want, ledgers)
    del want
    shrink_phase(A)
    recovery_phase(A)
    square_phase(rng)
    ragged_phase(rng)
    spread_phase(A)
    for rec in records:
        rec["launches_by_path"] = {path: counts[rec["name"]]
                                   for path, counts in PATH_LAUNCHES.items()}
    print(card, flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
