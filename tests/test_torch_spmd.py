"""One process per lane (``repro_torch.launch.spmd_qr`` over ``AxisComm``):
four spawned ranks in a gloo group on the CPU, against the port's
single-process ``SimComm`` runs and the JAX package's ``SimComm`` runs.

Held, as the port's contracts say:
- every leaf of R, factors and bundles bit-equal to the port's ``SimComm``
  run (kill == failure-free, ``MDSScheme(f=1)`` == XOR);
- REBUILD ledgers ``(point, lane, reads)`` exactly equal to the port's
  single-process run, parity bytes equal to the port's ``SimComm`` encode
  of the same state;
- in the MDS case (two deaths on the ragged geometry), the ledger also
  equal to the JAX package's ``SimComm`` run, and R within
  ``repro.kernels.ref.tolerances`` (f32) of it. Every other case is tied
  to the port's single-process run bit for bit, which the port's other
  test files hold against the JAX package.

One module fixture spawns the group; each case runs on it. The geometries
are the reference differentials' b = 4 tiles.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.ft as jft
from repro.core import SimComm as JSimComm
from repro.kernels.ref import tolerances
from repro_torch.core import SimComm, caqr_factorize, dist_orthonormalize, ft_tsqr
from repro_torch.core.lstsq import caqr_lstsq
from repro_torch.ft import (
    FailureSchedule,
    MDSScheme,
    UnrecoverableFailure,
    XORPairScheme,
    ft_caqr_sweep,
    iter_sweep_points,
    sweep_point,
)
from repro_torch.ft.online import state as tstate
from repro_torch.launch import spmd_qr

RTOL, ATOL = tolerances(np.float32)
P = 4


@pytest.fixture(scope="module")
def group():
    g = spmd_qr.make_lane_group(P, device="cpu", timeout_s=60.0)
    yield g
    g.close()
    assert not any(p.is_alive() for p in g._procs)


def _matrix(m, n, seed=3):
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


def _lanes(A):
    return torch.from_numpy(A).reshape(P, -1, A.shape[1])


def _leaves(res):
    return (res.R, *res.factors, *(res.bundles or ()))


def _assert_bitwise(got, want, tag=""):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), tag
    for x, y in zip(g, w):
        assert x.shape == y.shape and x.dtype == y.dtype, tag
        assert torch.equal(x, y), f"{tag}: a leaf differs"


def _close(got, want):
    w = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), w, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(w).max()))


def _ledger(events):
    return [(tuple(e.point), e.lane, dict(e.reads)) for e in events]


def _reports_ok(group):
    reps = group.last_reports
    assert [r.rank for r in reps] == list(range(P))
    assert all(r.staged["collectives"] > 0 and r.seconds > 0 for r in reps)


# -- the SPMD entries -----------------------------------------------------------


def test_caqr_factorize_spmd_matches_simcomm(group):
    A = _matrix(P * 8, 16)
    got = spmd_qr.caqr_factorize_lanes(A, 4, group)
    _assert_bitwise(got, caqr_factorize(_lanes(A), SimComm(P), 4), "caqr")
    _reports_ok(group)


def test_ft_tsqr_spmd_matches_simcomm(group):
    A = _matrix(P * 8, 4, seed=5)
    got = spmd_qr.ft_tsqr_lanes(A, group)
    want = ft_tsqr(_lanes(A), SimComm(P))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(got.R, got.R[:1].expand_as(got.R))


def test_dist_orthonormalize_spmd_matches_simcomm(group):
    A = _matrix(P * 8, 4, seed=6)
    Q, R = spmd_qr.dist_orthonormalize_lanes(A, group)
    Qs, Rs = dist_orthonormalize(_lanes(A), SimComm(P))
    assert torch.equal(Q, Qs) and torch.equal(R, Rs)
    Qf = Q.reshape(-1, 4).double()
    assert torch.allclose(Qf.T @ Qf, torch.eye(4, dtype=torch.float64),
                          atol=1e-5)


def test_caqr_lstsq_spmd_matches_simcomm(group):
    A, rhs = _matrix(P * 8, 16, seed=8), _matrix(P * 8, 2, seed=9)
    x = spmd_qr.caqr_lstsq_lanes(A, rhs, 4, group)
    assert torch.equal(x, caqr_lstsq(_lanes(A), _lanes(rhs), SimComm(P), 4))
    x64 = np.linalg.lstsq(A.astype(np.float64), rhs.astype(np.float64),
                          rcond=None)[0]
    np.testing.assert_allclose(x.numpy(), x64, rtol=1e-3, atol=1e-3)


# -- the scheduled FT sweep across ranks ----------------------------------------

SWEEPS = {
    "ragged-free": (6, 10, None),
    "ragged-leaf": (6, 10, {sweep_point(0, "leaf"): [1]}),
    "ragged-tsqr": (6, 10, {sweep_point(1, "tsqr", 0): [2]}),
    "ragged-trailing": (6, 10, {sweep_point(2, "trailing", 1): [3]}),
    "aligned-2kills": (8, 16, {sweep_point(0, "trailing", 0): [1],
                               sweep_point(3, "trailing", 1): [1]}),
    "wide-kill": (4, 24, {sweep_point(2, "trailing", 1): [2]}),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_ft_sweep_spmd_bitwise_with_simcomm_ledger(group, case):
    """Kill == failure-free across processes, and the REBUILD ledger equal
    to the port's single-process ledger."""
    m_loc, n, events = SWEEPS[case]
    A = _matrix(P * m_loc, n)
    sched = FailureSchedule(events=events) if events else None
    got = spmd_qr.ft_caqr_sweep_spmd(A, 4, sched, group=group)
    free = caqr_factorize(_lanes(A), SimComm(P), 4, collect_bundles=True,
                          use_scan=False)
    _assert_bitwise(got, free, case)
    _reports_ok(group)
    sim = ft_caqr_sweep(_lanes(A), SimComm(P), 4, schedule=sched)
    assert _ledger(got.events) == _ledger(sim.events)
    assert len(got.events) == sum(len(v) for v in (events or {}).values())


def test_mds_f2_two_deaths_spmd(group):
    """Two simultaneous non-buddy deaths decoded jointly across ranks:
    bit-equal to failure-free, the ledger of both single-process runs (port
    and JAX), R within tolerance of JAX's, and the parity bytes of the
    port's SimComm encode at that point."""
    A = _matrix(P * 6, 10, seed=11)
    point = sweep_point(1, "trailing", 0)
    events = {point: [0, 3]}  # no butterfly level pairs lanes 0 and 3
    got = spmd_qr.ft_caqr_sweep_spmd(A, 4, FailureSchedule(events=events),
                                     group=group, scheme=MDSScheme(f=2))
    free = caqr_factorize(_lanes(A), SimComm(P), 4, collect_bundles=True,
                          use_scan=False)
    _assert_bitwise(got, free, "mds f=2")
    sim = ft_caqr_sweep(_lanes(A), SimComm(P), 4,
                        schedule=FailureSchedule(events=events),
                        scheme=MDSScheme(f=2))
    want = jft.ft_caqr_sweep(jnp.asarray(A).reshape(P, 6, 10), JSimComm(P), 4,
                             schedule=jft.FailureSchedule(events=events),
                             scheme=jft.MDSScheme(f=2))
    assert _ledger(got.events) == _ledger(sim.events) == _ledger(want.events)
    assert all(e.reads["coded.parity1"] == P + 1 for e in got.events)
    _close(got.R, want.R)

    parity = spmd_qr.mds_parity_lanes(A, 4, 2, point, group)
    comm = SimComm(P)
    state = tstate.initial_sweep_state(comm, _lanes(A), 4)
    steps = list(iter_sweep_points(state.geom.n_panels, state.geom.levels))
    state = tstate.run_steps(comm, state, steps.index(point) + 1)
    sim_parity = MDSScheme(f=2).refresh(comm, state).code
    assert len(parity) == len(sim_parity)
    for x, y in zip(parity, sim_parity):
        assert x.dtype == torch.uint8 and torch.equal(x, y)


def test_mds_f1_equals_xor_spmd(group):
    A = _matrix(P * 8, 16, seed=12)
    sched = FailureSchedule(events={sweep_point(2, "tsqr", 1): [2]})
    mds = spmd_qr.ft_caqr_sweep_spmd(A, 4, sched, group=group,
                                     scheme=MDSScheme(f=1))
    xor = spmd_qr.ft_caqr_sweep_spmd(A, 4, sched, group=group,
                                     scheme=XORPairScheme())
    _assert_bitwise(mds, xor, "f=1 vs xor")
    assert _ledger(mds.events) == _ledger(xor.events)
    assert all(not k.startswith("coded.") for e in mds.events for k in e.reads)


# -- failure handling of the launcher -------------------------------------------


def test_unrecoverable_schedule_raises_in_caller(group):
    """A buddy pair dying at one point: every rank raises the same
    ``UnrecoverableFailure``, the caller raises it with the rank's message,
    and the group stays usable."""
    A = _matrix(P * 6, 10)
    sched = FailureSchedule(events={sweep_point(1, "trailing", 0): [2, 3]})
    with pytest.raises(UnrecoverableFailure, match="rank 0"):
        spmd_qr.ft_caqr_sweep_spmd(A, 4, sched, group=group)
    assert not group.closed
    got = spmd_qr.ft_caqr_sweep_spmd(A, 4, None, group=group)
    _assert_bitwise(got, caqr_factorize(_lanes(A), SimComm(P), 4,
                                        collect_bundles=True, use_scan=False))


def test_rank_that_raises_alone_closes_the_group(monkeypatch):
    """Rank 1 raises before its first collective while rank 0 waits in it:
    the caller raises rank 1's error once the error grace has passed, far
    inside the group's timeout, and the group's processes are gone."""
    import time

    monkeypatch.setattr(spmd_qr, "_ERROR_GRACE_S", 1.0)
    with spmd_qr.make_lane_group(2, device="cpu", timeout_s=60.0) as g:
        A = _matrix(2 * 4, 8)
        t0 = time.monotonic()
        with pytest.raises(TypeError, match="rank 1"):
            g.run(spmd_qr._task, spmd_qr.ft_caqr_sweep_rank, "cpu", (4,),
                  {}, each=[((A[:4],),), (("not a matrix",),)])
        assert time.monotonic() - t0 < 30
        assert g.closed
        for p in g._procs:
            p.join(timeout=10)
            assert not p.is_alive()
        with pytest.raises(RuntimeError, match="closed"):
            g.run(spmd_qr.pow2_lanes, 4)


def test_launcher_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spmd_qr.make_lane_group(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spmd_qr.ft_caqr_sweep_spmd(_matrix(8, 4), 4)
    with pytest.raises(ValueError):
        spmd_qr.make_lane_group(3, device="cpu")
    assert spmd_qr.pow2_lanes(6) == 4 and spmd_qr.pow2_lanes(1) == 1
