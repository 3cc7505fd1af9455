"""Time the one-process-per-lane paths of the PyTorch port on one card, on
the tall matrix of ``chip_smoke.py`` (32768 x 4096 f32 from ``--seed``,
8 ranks of 4096 rows, b = 128):

- ``parity``: ``mds_parity_lanes`` after the first panel's leaf point
  (``MDSScheme(f=2)``, the sweep's first 8 points and one refresh across
  the ranks), ``--reps`` times: seconds, each rank's collectives, their
  seconds and bytes, and a digest of the parity bytes;
- ``round_trip`` (a tree with ``SpmdSweepStep``): the online runner drives
  the sweep to the start of panel ``--panel``, then each of that panel's
  points is timed with deltas (the runner that made the state), without
  them (every leaf shipped to the ranks and joined back at every point),
  and with deltas from the state after a REBUILD of lane 2 on the parent
  (every leaf a new tensor, so the first point ships them all); the three
  end states must be bit-equal to the single process's.

    PYTHONPATH=<tree>/src python3 tools/spmd_online_timing.py [--seed N]

To compare two trees (for example a change and its parent unpacked with
``git archive`` into a git-ignored directory), run the script under each
in one call, in the order parent, change, change, parent. Prints a JSON
line for each part; needs CUDA; imports no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

P, M_LOC, N, B = 8, 4096, 4096, 128


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def ranks(group) -> list:
    return [dict(rank=r.rank, seconds=r.seconds, staged=r.staged)
            for r in group.last_reports]


def parity(Af, group, reps: int) -> dict:
    from repro_torch.ft import sweep_point
    from repro_torch.launch import spmd_qr

    runs = []
    for _ in range(reps):
        code, sec = timed(lambda: spmd_qr.mds_parity_lanes(
            Af, B, 2, sweep_point(1, "leaf"), group))
        h = hashlib.sha256()
        for c in code:
            h.update(c.cpu().numpy().tobytes())
        runs.append(dict(seconds=sec, digest=h.hexdigest()[:16],
                         parity_bytes=sum(c.numel() for c in code),
                         ranks=ranks(group)))
        del code
    return dict(point=[1, "leaf", 0], runs=runs)


def round_trip(A, group, panel: int) -> dict:
    from repro_torch.core import SimComm
    from repro_torch.ft.driver import recover_lanes
    from repro_torch.ft.failures import prev_sweep_point
    from repro_torch.ft.online import state as sm
    from repro_torch.launch import spmd_qr

    comm = SimComm(P)
    s = sm.initial_sweep_state(comm, A, B)
    per_panel = sm.panel_points(s.geom)
    step = spmd_qr.SpmdSweepStep(group)
    out = {}
    try:
        t0 = time.perf_counter()
        for _ in range(panel * per_panel):
            s = step(s)
        torch.cuda.synchronize()
        out["drive_seconds"] = time.perf_counter() - t0
        out["drive_points"] = panel * per_panel
        mid = want = s
        single = []
        for _ in range(per_panel):
            want, sec = timed(lambda: sm.sweep_step(comm, want))
            single.append(sec)
        out["single_process_point_seconds"] = single
        geom = mid.geom
        point = prev_sweep_point(mid.cursor, geom.n_panels, geom.levels)
        healed, _ = recover_lanes(comm, mid, [2], point, {2})
        # with deltas: the runner that made ``mid``; after a REBUILD every
        # leaf is a new tensor, so a runner's first point ships them all
        for name, runner, start in (
                ("deltas", step, mid),
                ("no_deltas", spmd_qr.SpmdSweepStep(group, deltas=False), mid),
                ("deltas_after_rebuild", spmd_qr.SpmdSweepStep(group),
                 healed)):
            before = runner.stats()
            s, pts = start, []
            for _ in range(per_panel):
                r0 = runner.rank_seconds
                b0 = [r.seconds for r in runner.reports] or [0.0] * P
                s, sec = timed(lambda: runner(s))
                # the wait for the ranks, and the slowest rank's
                # sweep_step alone (its report)
                pts.append(dict(seconds=sec,
                                rank_seconds=runner.rank_seconds - r0,
                                body_seconds=max(
                                    r.seconds - b for r, b in zip(
                                        runner.reports, b0))))
            after = runner.stats()
            if runner is not step:
                runner.close()
            a, b = sm.flat_arrays(s), sm.flat_arrays(want)
            same = a.keys() == b.keys() and all(
                torch.equal(a[k], b[k]) for k in a)
            out[name] = dict(
                points=pts, bitwise_equal_single_process=same,
                **{k: after[k] - before[k] for k in (
                    "leaves_shipped", "bytes_shipped", "leaves_returned",
                    "bytes_returned")})
            if not same:
                raise RuntimeError(f"{name}: the state differs from the "
                                   "single process's")
    finally:
        step.close()
    out["panel"] = panel
    out["leaves_in_state"] = len(sm.flat_arrays(mid))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--panel", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("spmd_online_timing: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core import block_row_layout
    from repro_torch.kernels import build
    from repro_torch.launch import spmd_qr

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    build.build_all()
    rng = np.random.default_rng(args.seed)
    A = block_row_layout(rng.standard_normal((P * M_LOC, N)).astype(
        np.float32), P)
    Af = A.reshape(-1, N)
    rec = dict(card=card, tree=spmd_qr.__file__)
    with spmd_qr.make_lane_group(P, timeout_s=300.0) as group:
        rec["parity"] = parity(Af, group, args.reps)
        print(json.dumps(rec), flush=True)
        if hasattr(spmd_qr, "SpmdSweepStep"):
            print(json.dumps(dict(round_trip=round_trip(A, group,
                                                        args.panel))),
                  flush=True)
    torch.cuda.ipc_collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
