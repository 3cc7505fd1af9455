"""The online and elastic FT sweep with one process per lane
(``repro_torch.launch.spmd_qr``: the host orchestrator in this process, one
``sweep_step`` a point in each of four spawned ranks in a gloo group on the
CPU), against the port's single-process ``SimComm`` runs, the scheduled
sweep across the same ranks and the JAX package's ``SimComm`` runs.

Held, as the reference's online SPMD differentials hold them
(``tests/test_spmd_ft_driver.py``, ``tests/test_coded_recovery.py``,
``tests/test_fused_sweep.py``, ``tests/test_spmd_bigp.py``):
- online failure-free and online with a runtime kill: every leaf of R,
  factors and bundles bit-equal to the scheduled sweep across the ranks
  and to the port's ``SimComm`` run, the ledger equal to the port's and
  to the JAX package's;
- an ``MDSScheme(f=2)`` buddy-pair kill decoded online over the ranks ==
  ``SimComm``; under XOR the same deaths raise ``UnrecoverableFailure`` in
  the caller;
- the step runner's state at every panel boundary == the fused ``SimComm``
  state, leaf for leaf;
- SHRINK (fold 4 -> 2) and BLANK: bit-equal to the port's single-process
  online run, R within ``repro.kernels.ref.tolerances`` of JAX's
  failure-free R up to row signs;
- double-buffered segments == the sync loop; a death found a boundary
  late (the killed rank runs a point on NaN) == one process; the runner
  without deltas == with them.

One module fixture spawns the group; the geometry is the reference
differentials' ragged one (P = 4, m_loc 6, n 10, b 4) and, for the elastic
cases, the aligned (8, 16).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.ft as jft
from repro.core import SimComm as JSimComm
from repro.kernels.ref import tolerances
from repro_torch.core import SimComm
from repro_torch.ft import (
    FailureSchedule,
    MDSScheme,
    ScriptedKiller,
    Semantics,
    UnrecoverableFailure,
    ft_caqr_sweep,
    ft_caqr_sweep_online,
    sweep_point,
)
from repro_torch.ft.failures import PHASE_LEAF
from repro_torch.ft.online import state as tstate
from repro_torch.ft.online.detect import DelayedDetector, NaNSentinelDetector
from repro_torch.launch import spmd_qr

RTOL, ATOL = tolerances(np.float32)
P, M_LOC, N, B = 4, 6, 10, 4
KILL = sweep_point(1, "trailing", 0)


@pytest.fixture(scope="module")
def group():
    g = spmd_qr.make_lane_group(P, device="cpu", timeout_s=60.0)
    yield g
    g.close()
    assert not any(p.is_alive() for p in g._procs)


def _matrix(m_loc=M_LOC, n=N, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (P * m_loc, n)).astype(np.float32)


def _lanes(A):
    return torch.from_numpy(A).reshape(P, -1, A.shape[1])


def _leaves(res):
    return (res.R, *res.factors, *res.bundles)


def _assert_bitwise(got, want, tag=""):
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), tag
    for x, y in zip(g, w):
        assert x.shape == y.shape and x.dtype == y.dtype, tag
        assert torch.equal(x, y), f"{tag}: a leaf differs"


def _ledger(events):
    return [(tuple(e.point), e.lane, dict(e.reads)) for e in events]


def _ranks_ran(group, points):
    reps = group.last_reports
    assert [r.rank for r in reps] == list(range(len(reps)))
    assert all(r.staged["collectives"] > 0 and r.seconds > 0 for r in reps)
    assert group.last_steps["points"] == points


def _signfix(R):
    R = np.asarray(R)
    s = np.sign(np.diag(R))
    return R * np.where(s == 0, 1.0, s)[:, None]


def _points(geom):
    return geom.n_panels * (1 + 2 * geom.levels)


# -- online REBUILD ---------------------------------------------------------------


@pytest.mark.parametrize("kills", [None, {KILL: [3]}], ids=["free", "kill"])
def test_online_spmd_equals_scheduled_and_simcomm(group, kills):
    """The reference's online differential: online over the ranks ==
    scheduled over the ranks == the port's SimComm run, and the ledger of
    both and (with the kill) of the JAX package's SimComm run."""
    A = _matrix()
    sched = FailureSchedule(events=kills) if kills else None
    hooks = [ScriptedKiller(kills)] if kills else []
    got = spmd_qr.ft_caqr_sweep_online_spmd(A, B, group=group,
                                            fault_hooks=hooks)
    geom = tstate.initial_sweep_state(SimComm(P), _lanes(A), B).geom
    _ranks_ran(group, _points(geom))
    scheduled = spmd_qr.ft_caqr_sweep_spmd(A, B, sched, group=group)
    sim = ft_caqr_sweep(_lanes(A), SimComm(P), B, schedule=sched)
    _assert_bitwise(got, scheduled, "online vs scheduled spmd")
    _assert_bitwise(got, sim, "online spmd vs simcomm")
    assert _ledger(got.events) == _ledger(scheduled.events) == _ledger(
        sim.events)
    if kills:
        want = jft.ft_caqr_sweep(
            jnp.asarray(A).reshape(P, M_LOC, N), JSimComm(P), B,
            schedule=jft.FailureSchedule(events=kills))
        assert _ledger(got.events) == _ledger(want.events)
    assert len(got.events) == (1 if kills else 0)


def test_mds_f2_buddy_pair_online_spmd(group):
    """A buddy-pair death (lanes 2 and 3) at one boundary, decoded jointly
    by ``MDSScheme(f=2)`` on the parent's global state between the ranks'
    points: == the scheduled SimComm run and failure-free, leaf for
    leaf, with its ledger."""
    A = _matrix()
    kills = {KILL: [2, 3]}
    got = spmd_qr.ft_caqr_sweep_online_spmd(
        A, B, group=group, fault_hooks=[ScriptedKiller(kills)],
        scheme=MDSScheme(f=2))
    sim = ft_caqr_sweep(_lanes(A), SimComm(P), B,
                        schedule=FailureSchedule(events=kills),
                        scheme=MDSScheme(f=2))
    _assert_bitwise(got, sim, "mds online spmd vs simcomm")
    _assert_bitwise(got, ft_caqr_sweep(_lanes(A), SimComm(P), B), "vs free")
    assert _ledger(got.events) == _ledger(sim.events)
    assert [e.lane for e in got.events] == [2, 3]
    assert all(e.reads["coded.parity1"] == P + 1 for e in got.events)


def test_buddy_pair_under_xor_raises_in_caller(group):
    """The same deaths under the XOR scheme: the parent's REBUILD finds no
    live source and the caller gets ``UnrecoverableFailure``; the group
    stays usable."""
    with pytest.raises(UnrecoverableFailure):
        spmd_qr.ft_caqr_sweep_online_spmd(
            _matrix(), B, group=group,
            fault_hooks=[ScriptedKiller({KILL: [2, 3]})])
    assert not group.closed
    got = spmd_qr.ft_caqr_sweep_online_spmd(_matrix(), B, group=group)
    _assert_bitwise(got, ft_caqr_sweep(_lanes(_matrix()), SimComm(P), B))


def test_async_segments_equal_sync(group, monkeypatch):
    """Double-buffered segments == the sync loop; the sync run with every
    shipped staging buffer released after its point, as the card does
    after a kill ships the whole state."""
    A = _matrix(seed=5)
    kills = {sweep_point(0, "tsqr", 1): [1], sweep_point(2, "leaf"): [2]}
    with monkeypatch.context() as m:
        m.setattr(spmd_qr, "_STAGING_KEEP", 0)
        sync = spmd_qr.ft_caqr_sweep_online_spmd(
            A, B, group=group, fault_hooks=[ScriptedKiller(kills)])
    dbl = spmd_qr.ft_caqr_sweep_online_spmd(
        A, B, group=group, fault_hooks=[ScriptedKiller(kills)],
        async_segments=True)
    _assert_bitwise(dbl, sync, "async vs sync")
    assert _ledger(dbl.events) == _ledger(sync.events)
    assert [e.lane for e in sync.events] == [1, 2]


def test_late_detection_runs_the_poisoned_rank(group):
    """A death the detector reports one boundary late: the killed lane's
    rank runs the next point (K1 of the next panel) on its NaN slices,
    then the parent heals it at the later point; == the same orchestrator
    in one process, and == failure-free."""
    A = _matrix()
    kill = {sweep_point(1, "trailing", 1): [3]}

    def late():
        return DelayedDetector(NaNSentinelDetector(), miss=1)

    got = spmd_qr.ft_caqr_sweep_online_spmd(
        A, B, detector=late(), group=group,
        fault_hooks=[ScriptedKiller(kill)])
    one = ft_caqr_sweep_online(_lanes(A), SimComm(P), B, detector=late(),
                               fault_hooks=[ScriptedKiller(kill)])
    _assert_bitwise(got, one, "late detection")
    _assert_bitwise(got, ft_caqr_sweep(_lanes(A), SimComm(P), B), "vs free")
    assert [(e.point, e.lane) for e in got.events] == [
        (sweep_point(2, "leaf"), 3)]
    assert _ledger(got.events) == _ledger(one.events)


def test_segment_points_and_deltas(group):
    """A panel a segment, the kill on its boundary: == the scheduled
    SimComm run, with its ledger. The runner without deltas ships every
    leaf at every point; with and without, the state after a panel and a
    point == the SimComm state, leaf for leaf."""
    A = _matrix(seed=6)
    geom = tstate.initial_sweep_state(SimComm(P), _lanes(A), B).geom
    kill = {sweep_point(1, "trailing", geom.levels - 1): [1]}
    seg = spmd_qr.ft_caqr_sweep_online_spmd(
        A, B, group=group, fault_hooks=[ScriptedKiller(kill)],
        segment_points=tstate.panel_points(geom))
    with_deltas = dict(group.last_steps)
    sim = ft_caqr_sweep(_lanes(A), SimComm(P), B,
                        schedule=FailureSchedule(events=kill))
    _assert_bitwise(seg, sim, "a panel a segment")
    assert _ledger(seg.events) == _ledger(sim.events)

    # one panel's points from the first state, without and with deltas
    comm = SimComm(P)
    s0 = tstate.initial_sweep_state(comm, _lanes(A), B)
    n_points = tstate.panel_points(geom) + 1
    want = tstate.flat_arrays(tstate.run_steps(comm, s0, n_points))
    runners = {d: spmd_qr.SpmdSweepStep(group, deltas=d) for d in (False, True)}
    try:
        for runner in runners.values():
            s = s0
            for _ in range(n_points):
                s = runner(s)
            got = tstate.flat_arrays(s)
            assert got.keys() == want.keys()
            assert all(torch.equal(got[k], want[k]) for k in want)
    finally:
        for runner in runners.values():
            runner.close()
    full, delta = runners[False], runners[True]
    assert full.points == delta.points == n_points
    # without deltas every leaf goes both ways at every point; with them
    # the first state goes out and only the new leaves come back
    assert full.leaves_shipped > 4 * delta.leaves_shipped
    assert full.leaves_returned > delta.leaves_returned
    assert with_deltas["points"] == _points(geom)


# -- the step runner against the fused SimComm sweep -----------------------------


def test_step_runner_boundaries_equal_fused_simcomm(group):
    """The reference's cross-backend closure: the runner's state at every
    panel boundary (and its finalize) == the fused SimComm state there,
    leaf for leaf, structure and all."""
    A = _lanes(_matrix())
    comm = SimComm(P)
    s_f = tstate.initial_sweep_state(comm, A, B)
    s_s = tstate.initial_sweep_state(comm, A, B)
    step = spmd_qr.make_spmd_sweep_step(group)
    try:
        boundaries = 0
        while s_f.cursor is not None:
            s_f = tstate.run_panel_fused(comm, s_f)
            s_s = step(s_s)
            while s_s.cursor is not None and s_s.cursor[1] != PHASE_LEAF:
                s_s = step(s_s)
            assert s_s.cursor == s_f.cursor and s_s.geom == s_f.geom
            a, b = tstate.flat_arrays(s_f), tstate.flat_arrays(s_s)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                assert torch.equal(a[k], b[k]), f"boundary {boundaries}: {k}"
            boundaries += 1
    finally:
        step.close()
    assert boundaries == s_f.geom.n_panels
    for x, y in zip(tstate.finalize(comm, s_f), tstate.finalize(comm, s_s)):
        for u, v in zip(torch.utils._pytree.tree_leaves(x),
                        torch.utils._pytree.tree_leaves(y)):
            assert torch.equal(u, v)


def test_rank_error_raises_in_caller(group):
    """A point the ranks refuse (the sweep is complete) raises the ranks'
    error in the caller, rank 0's message first; the group stays usable
    and the same runner goes on from a valid state, bit-equal to one
    process."""
    comm = SimComm(P)
    s0 = tstate.initial_sweep_state(comm, _lanes(_matrix()), B)
    done = tstate.run_steps(comm, s0)
    step = spmd_qr.make_spmd_sweep_step(group)
    try:
        s = step(step(s0))
        with pytest.raises(AssertionError, match="rank 0"):
            step(done)
        assert not group.closed
        s = step(s)
        want = tstate.flat_arrays(tstate.run_steps(comm, s0, 3))
        got = tstate.flat_arrays(s)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    finally:
        step.close()


# -- elastic ----------------------------------------------------------------------


@pytest.mark.parametrize("semantics", [Semantics.SHRINK, Semantics.BLANK],
                         ids=["shrink", "blank"])
def test_elastic_spmd(group, semantics):
    """The reference's big-P elastic cell at four lanes: a runtime kill,
    healed, then the sweep re-meshes at the next panel boundary under the
    fold policy (SHRINK: onto a subgroup of the first two ranks; BLANK:
    the four ranks, the dead lane's slot a hole). Bit-equal to the
    port's single-process online run; R within tolerance of JAX's
    failure-free R up to row signs."""
    m_loc, n = 8, 16
    A = _matrix(m_loc, n, seed=7)
    kill = {sweep_point(1, "trailing", 0): [3]}
    res = spmd_qr.ft_caqr_sweep_elastic_spmd(
        A, B, group=group, semantics=semantics,
        fault_hooks=[ScriptedKiller(kill)])
    one = ft_caqr_sweep_online(
        _lanes(A), SimComm(P), B, fault_hooks=[ScriptedKiller(kill)],
        semantics=semantics, elastic_policy="fold")
    assert torch.equal(res.R, one.R)
    assert res.transitions == one.transitions and res.world == one.world
    assert _ledger(res.events) == _ledger(one.events)
    assert [t.kind for t in res.transitions] == [semantics.value]
    assert res.transitions[0].world_before.n_slots == P
    # SHRINK folds the three survivors onto two slots; BLANK keeps the
    # dead lane's slot as a hole
    slots = 2 if semantics is Semantics.SHRINK else P
    assert res.world.n_slots == slots and res.world.n_live == min(slots, 3)
    assert group.last_steps["worlds"] == [P, slots]
    ref = jft.ft_caqr_sweep(jnp.asarray(A).reshape(P, m_loc, n),
                            JSimComm(P), B)
    np.testing.assert_allclose(_signfix(res.R), _signfix(ref.R[0]),
                               rtol=RTOL, atol=ATOL)


def test_entries_raise_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    A = _matrix()
    for entry in (spmd_qr.ft_caqr_sweep_online_spmd,
                  spmd_qr.ft_caqr_sweep_elastic_spmd):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(A, B)
