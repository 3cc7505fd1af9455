"""Drive the PyTorch/CUDA port of FT-CAQR on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. report and build: the card's name and power limit; every CUDA kernel
   of the sweep built from ``src/repro_torch/csrc`` (one nvcc per source).
2. kernels: K1-K4 at the sweep's shapes against their plain PyTorch
   versions, and timed with CUDA events beside the plain version and one
   PyTorch call computing the same function; one JSON line per kernel.
3. sweep: the windowed FT-CAQR sweep of a 32768 x 4096 f32 matrix over
   P = 8 lanes at panel width 128 (32 panels, 3 butterfly levels), with
   the launch counters at 0 before it; checks that every kernel ran, that
   R is replicated bitwise, the Gram identity, Q^T A = [R; 0] and a
   least-squares solve.
   Then device time by kernel over one more sweep, from torch.profiler.
4. recovery: the FT trailing update of one panel with lane 3 killed after
   level 1 and rebuilt from one buddy, bitwise equal to the clean run.
5. ragged: an unaligned 32000 x 4000 sweep checked by the Gram identity.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Needs CUDA; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core import SimComm, caqr_apply_qt, caqr_factorize, ft_tsqr  # noqa: E402
from repro_torch.core import block_row_layout, recovery  # noqa: E402
from repro_torch.core.lstsq import caqr_lstsq  # noqa: E402
from repro_torch.kernels import backend, build, ops, ref  # noqa: E402

P, M_LOC, N, B = 8, 4096, 4096, 128
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
}


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


def kernel_phase(A: torch.Tensor) -> list:
    """K1-K4 on the first panel's data of the sweep, against their plain
    versions; returns one record per kernel."""
    rtol, _ = ref.tolerances(torch.float32)
    f = 4.0  # bytes per float
    panel = A[..., :B].contiguous()
    rows = [(i, i ^ 1) for i in range(P)]
    C = A  # panel 0's live window is the whole width
    cases = {}
    Y, T, R = ops.panel_qr(panel, 0)
    cases["panel_qr"] = dict(
        run=lambda: ops.panel_qr(panel, 0), plain=lambda: ref.panel_qr(panel, 0),
        lib=lambda: torch.geqrf(panel),
        flops=P * (3.0 * M_LOC * B * B - B ** 3 / 3.0),
        nbytes=f * P * (2 * M_LOC * B + 2 * B * B), reps=5)
    cases["wy_apply"] = dict(
        run=lambda: ops.wy_apply(Y, T, C), plain=lambda: ref.wy_apply(Y, T, C),
        lib=lambda: C - Y @ (T.mT @ (Y.mT @ C)),
        flops=P * (4.0 * M_LOC * B * N + B * B * N),
        nbytes=f * P * (M_LOC * B + B * B + 2 * M_LOC * N), reps=10)
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
    cases["stacked_apply"] = dict(
        run=lambda: ops.stacked_apply(Y2, T2, Ct, Cb),
        plain=lambda: ref.stacked_apply(Y2, T2, Ct, Cb),
        lib=lambda: (lambda W: (Ct - W, Cb - Y2 @ W, W))(
            T2.mT @ (Ct + Y2.mT @ Cb)),
        flops=P * 3.0 * B * B * N, nbytes=f * P * (2 * B * B + 5 * B * N),
        reps=10)

    # Determinism: one lane of the P-lane launch equals a launch of it alone.
    k = P - 3
    one = ops.stacked_qr(R_top[k], R_bot[k])
    check(all(torch.equal(a[k], o) for a, o in
              zip(ops.stacked_qr(R_top, R_bot), one)),
          "stacked_qr: lane bits depend on the launch")
    one = ops.wy_apply(Y[k], T[k], C[k])
    check(torch.equal(ops.wy_apply(Y, T, C)[k], one),
          "wy_apply: lane bits depend on the launch")

    records = []
    for name, c in cases.items():
        got, want = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        err, scaled = max_err(got if isinstance(got, tuple) else (got,),
                              want if isinstance(want, tuple) else (want,))
        check(scaled <= rtol, f"{name}: scaled error {scaled} over tolerance {rtol}")
        ms = time_ms(c["run"], c["reps"])
        plain_ms = time_ms(c["plain"], 2 if name == "panel_qr" else c["reps"])
        lib_ms = time_ms(c["lib"], c["reps"])
        bms, by = bound_ms(c["flops"], c["nbytes"])
        source, replaces = KERNELS[name]
        rec = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err, scaled_err=scaled,
                   tolerance=rtol, ms=ms,
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=lib_ms)
        emit({"kernel": rec})
        records.append(rec)
    return records


def gram_error(A_flat64: torch.Tensor, R: torch.Tensor) -> float:
    G = A_flat64.T @ A_flat64
    R64 = R.double()
    return float((R64.T @ R64 - G).abs().max() / G.abs().max())


def sweep_phase(A: torch.Tensor, rng):
    """The main path, launch counters at 0 before it; returns the launches
    and the sweep's seconds."""
    comm = SimComm(P)
    backend.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = caqr_factorize(A, comm, B, use_scan=False, collect_bundles=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(backend.LAUNCHES)
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched by the sweep: {launches}")
    check(bool((res.R == res.R[:1]).all()), "R is not replicated bitwise")
    m = P * M_LOC
    flops = 2.0 * m * N * N - 2.0 * N ** 3 / 3.0
    A64 = A.reshape(-1, N).double()
    R0 = res.R[0]
    gram = gram_error(A64, R0)
    check(gram <= GRAM_TOL, f"Gram identity: {gram} > {GRAM_TOL}")
    res = res._replace(bundles=None)
    QtA = caqr_apply_qt(A, res.factors, comm).reshape(-1, N)
    rmax = float(R0.abs().max())
    top = float((QtA[:N] - R0).abs().max()) / rmax
    rest = float(QtA[N:].abs().max()) / rmax
    check(max(top, rest) <= QTA_TOL, f"Q^T A != [R; 0]: {top}, {rest}")
    rhs = block_row_layout(rng.standard_normal((m, 1)).astype(np.float32), P)
    x = caqr_lstsq(A, rhs, comm, B, result=res).double()
    b64 = rhs.reshape(-1, 1).double()
    x_ne = torch.linalg.solve(A64.T @ A64, A64.T @ b64)
    lst = float((x - x_ne).norm() / x_ne.norm())
    check(lst <= LSTSQ_TOL, f"lstsq vs normal equations: {lst}")
    out = dict(shape=[m, N], P=P, b=B, panels=N // B, levels=P.bit_length() - 1,
               seconds=seconds, gflops=flops / seconds / 1e9,
               launches=launches, gram_rel_err=gram, qta_top_rel_err=top,
               qta_rest_rel=rest, lstsq_rel_err=lst,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"sweep": out})
    return launches, seconds


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
    by_kernel = {name: 0.0 for name in KERNELS}
    other = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        name = next((k for k in KERNELS if e.key.startswith(k + "_kernel")), None)
        if name is None:
            other += us / 1e3
        else:
            by_kernel[name] += us / 1e3
    busy = sum(by_kernel.values()) + other
    emit({"profile": dict(profiled_wall_ms=wall_ms, kernel_ms=by_kernel,
                          other_device_ms=other, device_ms=busy,
                          device_busy_share=busy / (sweep_seconds * 1e3))})


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


def ragged_phase(rng) -> None:
    m_loc, n = 4000, 4000
    A_np = rng.standard_normal((P * m_loc, n)).astype(np.float32)
    A = block_row_layout(A_np, P)
    res = caqr_factorize(A, SimComm(P), B, use_scan=False)
    torch.cuda.synchronize()
    check(tuple(res.R.shape) == (P, n, n), f"ragged R shape {res.R.shape}")
    gram = gram_error(A.reshape(-1, n).double(), res.R[0])
    emit({"ragged": dict(m_loc=m_loc, n=n, b=B, gram_rel_err=gram)})
    check(gram <= GRAM_TOL, f"ragged Gram identity: {gram} > {GRAM_TOL}")


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
    records = kernel_phase(A)
    launches, sweep_seconds = sweep_phase(A, rng)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    profile_phase(A, sweep_seconds)
    recovery_phase(A)
    ragged_phase(rng)
    print(card, flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
