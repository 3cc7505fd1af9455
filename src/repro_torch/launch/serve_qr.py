"""QR-service driver of the port (counterpart of
``src/repro/launch/serve_qr.py``):

    python -m repro_torch.launch.serve_qr [--device cuda|cpu] [--kill-lane L]

Generates a synthetic burst of ragged factorization and least-squares
requests from ``--seed``, streams them through the continuous-batching
``QRService`` (``repro_torch.serve.qr_service``), optionally kills a lane
mid-batch, and reports sustained throughput and latency percentiles. Every
retired R is checked against ``numpy.linalg.qr`` of the tenant's own
matrix (sign-fixed rows), and lstsq solutions against
``numpy.linalg.lstsq``, so the run is a correctness smoke as well as a
traffic demo. Runs on the GPU by default; ``--device cpu`` runs the plain
path on the CPU.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import SimComm
from repro_torch.serve.qr_service import QRService


def make_requests(rng: np.random.Generator, count: int, b: int,
                  max_m: int, max_n: int, lstsq_frac: float):
    """Ragged synthetic traffic: shapes uniform in [b, max]; a fraction
    carries a right-hand side of two columns (the lstsq tenants, m >= n
    only)."""
    reqs = []
    for _ in range(count):
        m = int(rng.integers(b, max_m + 1))
        n = int(rng.integers(b, max_n + 1))
        A = rng.standard_normal((m, n)).astype(np.float32)
        rhs = None
        if rng.random() < lstsq_frac and m >= n:
            rhs = rng.standard_normal((m, 2)).astype(np.float32)
        reqs.append((A, rhs))
    return reqs


def verify(res, A, rhs) -> None:
    """R against numpy's float64 QR of ``A`` (rows sign-fixed by their
    diagonals) and x against numpy's lstsq; raises on a mismatch."""
    k, n = min(A.shape), A.shape[1]
    _Q, R_ref = np.linalg.qr(A.astype(np.float64), mode="reduced")
    # QR is unique up to column signs of Q / row signs of R
    s = np.sign(np.diag(R_ref[:k, :k]))
    s[s == 0] = 1.0
    R_ref = s[:, None] * R_ref[:k, :n]
    s_got = np.sign(np.diag(res.R[:k, :k]))
    s_got[s_got == 0] = 1.0
    R_got = s_got[:, None] * res.R
    if not np.allclose(R_got, R_ref, atol=1e-3):
        raise AssertionError(f"{res.rid}: R mismatch, max err "
                             f"{np.abs(R_got - R_ref).max():.2e}")
    if rhs is not None:
        x_ref, *_ = np.linalg.lstsq(
            A.astype(np.float64), rhs.astype(np.float64), rcond=None)
        if not np.allclose(res.x, x_ref, atol=1e-2):
            raise AssertionError(f"{res.rid}: lstsq mismatch, max err "
                                 f"{np.abs(res.x - x_ref).max():.2e}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--panel-width", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-m", type=int, default=24)
    ap.add_argument("--max-n", type=int, default=12)
    ap.add_argument("--lstsq-frac", type=float, default=0.3)
    ap.add_argument("--arrive-every", type=int, default=1,
                    help="submit one request per this many ticks (0 = all "
                         "up front)")
    ap.add_argument("--kill-lane", type=int, default=-1,
                    help="kill this lane mid-batch (-1 = failure-free)")
    ap.add_argument("--kill-tick", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where tenant states live (cuda, or cpu for the "
                         "plain path)")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    comm = SimComm(args.lanes)
    b = args.panel_width
    m_loc = -(-args.max_m // args.lanes)
    m_loc += (-m_loc) % b
    bucket = (m_loc, args.max_n + 2)   # +2: room for the lstsq rhs columns
    svc = QRService(comm, panel_width=b, buckets=[bucket],
                    max_slots=args.slots, device=args.device)
    reqs = make_requests(rng, args.requests, b, args.max_m, args.max_n,
                         args.lstsq_frac)

    pending = list(reqs)
    by_rid = {}
    t0 = time.perf_counter()
    killed = False
    while pending or svc.queue or svc.resident:
        if args.arrive_every == 0:
            while pending:
                A, rhs = pending.pop(0)
                by_rid[svc.submit(A, rhs)] = (A, rhs)
        elif pending and svc.tick_count % args.arrive_every == 0:
            A, rhs = pending.pop(0)
            by_rid[svc.submit(A, rhs)] = (A, rhs)
        if (args.kill_lane >= 0 and not killed
                and svc.tick_count == args.kill_tick):
            svc.kill_lane(args.kill_lane)
            killed = True
        svc.tick()
    wall = time.perf_counter() - t0

    lat = np.array(sorted(r.latency_s for r in svc.results.values()))
    heals = sum(len(r.events) for r in svc.results.values())
    for rid, (A, rhs) in by_rid.items():
        verify(svc.results[rid], A, rhs)
    print(f"served {len(svc.results)} requests on {svc.device} in "
          f"{wall:.2f}s ({len(svc.results) / wall:.1f} req/s) over "
          f"{svc.tick_count} ticks; p50 {lat[len(lat) // 2] * 1e3:.1f}ms "
          f"p99 {lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3:.1f}ms; "
          f"{heals} tenant REBUILDs; "
          f"{svc.compiled_programs} resident segment runners")
    print("all results verified against numpy QR/lstsq")


if __name__ == "__main__":
    main()
