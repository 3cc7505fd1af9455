"""The port's elastic execution (``repro_torch.ft.elastic``) against the
JAX package's ``repro.ft.elastic``, and its bitwise contract inside the
port.

Discrete outputs must equal the reference's exactly: the transition plans
(``plan_transition``), the ``TransitionEvent`` and ``EpochRecord`` worlds,
the final ``LaneWorld`` and the heal ledgers. R is compared within the
f32 pair of ``repro.kernels.ref.tolerances`` and meets the Gram identity
R^T R = A^T A. Inside the port, the scheduled elastic driver and the
online orchestrator share one controller, so their R is bit-identical.
"""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.ft.elastic as jel
from repro.core import SimComm as JSimComm
from repro.ft import FailureSchedule as JSchedule
from repro.ft import Semantics as JSemantics
from repro.ft.online import state as jstate
from repro.kernels.ref import tolerances
from repro_torch import interop
from repro_torch.core import SimComm, caqr_factorize, sweep_geometry
from repro_torch.ft import (
    FailureSchedule,
    ScriptedKiller,
    Semantics,
    SweepOrchestrator,
    UnrecoverableFailure,
    ft_caqr_sweep,
    iter_sweep_points,
)
from repro_torch.ft import elastic as tel
from repro_torch.ft.online import state as tstate

RTOL, ATOL = tolerances(np.float32)

# the reference's acceptance geometry: ragged rows and columns, 3 panels
RP, RM_LOC, RN, RB = 4, 6, 10, 4
RGEOM = sweep_geometry(RP, RM_LOC, RN, RB)
R_POINTS = list(iter_sweep_points(RGEOM.n_panels, RGEOM.levels))


def _matrix(P, m_loc, n, seed=3):
    return np.random.default_rng(seed).standard_normal((P, m_loc, n)).astype(
        np.float32)


def _world(w):
    return (w.n_slots, tuple(w.live), w.col_base)


def _transition(t):
    return (t.kind, t.frontier, tuple(t.lanes), t.adopter,
            _world(t.world_before), _world(t.world_after))


def _ledger(events):
    return [(tuple(e.point), e.lane, dict(e.reads)) for e in events]


def _assert_matches_reference(got, want):
    """Records and ledgers exactly, R within tolerance."""
    assert [_transition(t) for t in got.transitions] == \
        [_transition(t) for t in want.transitions]
    assert _world(got.world) == _world(want.world)
    assert _ledger(got.events) == _ledger(want.events)
    w = np.asarray(want.R)
    assert tuple(got.R.shape) == w.shape
    np.testing.assert_allclose(got.R.numpy(), w, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(w).max()))


def _gram_ok(A, R):
    A64 = A.reshape(-1, A.shape[-1]).astype(np.float64)
    R64 = R.numpy().astype(np.float64)
    G = A64.T @ A64
    assert np.abs(R64.T @ R64 - G).max() <= 1e-5 * np.abs(G).max()


def _both(A, schedule, **kw):
    """The port's and the JAX package's scheduled elastic sweeps."""
    jkw = dict(kw)
    if "semantics" in jkw:
        jkw["semantics"] = JSemantics(jkw["semantics"].value)
    got = tel.ft_caqr_sweep_elastic(
        torch.from_numpy(A), SimComm(A.shape[0]), RB,
        schedule=FailureSchedule(events=schedule), **kw)
    want = jel.ft_caqr_sweep_elastic(
        jnp.asarray(A), JSimComm(A.shape[0]), RB,
        schedule=JSchedule(events=schedule), **jkw)
    return got, want


# -- plans --------------------------------------------------------------------


def test_pow2_helpers_match():
    for x in range(1, 70):
        assert tel.ceil_pow2(x) == jel.ceil_pow2(x)
        assert tel.floor_pow2(x) == jel.floor_pow2(x)


def _worlds():
    yield tel.LaneWorld(n_slots=2, live=(True, True)), \
        jel.LaneWorld(n_slots=2, live=(True, True))
    for n in (4, 8):
        yield tel.LaneWorld(n_slots=n, live=(True,) * n), \
            jel.LaneWorld(n_slots=n, live=(True,) * n)
    live = (True, True, False, True, True, True, True, False)
    yield tel.LaneWorld(n_slots=8, live=live, col_base=8), \
        jel.LaneWorld(n_slots=8, live=live, col_base=8)


@pytest.mark.parametrize("kind,policy", [("shrink", "pad"), ("shrink", "fold"),
                                         ("blank", "pad"), ("grow", "pad"),
                                         ("grow", "fold")])
def test_plan_tables_equal_reference(kind, policy):
    """Every one- and two-lane death of several worlds (and a grow): the
    source table, the world after and the adopter equal the reference's."""
    for tw, jw in _worlds():
        deads = [()] if kind == "grow" else [
            d for t in (1, 2) for d in itertools.combinations(tw.live_lanes, t)
            if len(d) < tw.n_live]
        for dead in deads:
            got = tel.plan_transition(tw, kind, dead, policy=policy)
            want = jel.plan_transition(jw, kind, dead, policy=policy)
            assert got[0] == want[0], (tw, dead)
            assert _world(got[1]) == _world(want[1]), (tw, dead)
            assert got[2] == want[2], (tw, dead)


def test_scatter_world_equals_reference():
    rng = np.random.default_rng(0)
    blocks = [rng.standard_normal((r, 5)).astype(np.float32)
              for r in (3, 0, 7, 4)]
    for even, n_live in ((False, None), (True, 3), (True, 2)):
        got = tel.scatter_world(blocks, 5, 4, even=even, n_live=n_live)
        want = jel.scatter_world(blocks, 5, 4, even=even, n_live=n_live)
        assert np.array_equal(got, want)


def test_harvest_equals_reference():
    """The harvest at a deposited frontier: the same row blocks, exactly,
    from the same state bytes."""
    jc = JSimComm(RP)
    js = jstate.run_steps(jc, jstate.initial_sweep_state(
        jc, jnp.asarray(_matrix(RP, RM_LOC, RN)), RB), 1 + 2 * RGEOM.levels)
    ts = tstate.sweep_state_from_host(jstate.sweep_state_to_host(js),
                                      device="cpu")
    js, r = jstate.deposit_boundary(jc, js)
    ts, r2 = tstate.deposit_boundary(SimComm(RP), ts)
    assert r == r2 == 1
    # the deposit is float work: compare the harvests of one state's bytes
    ts = tstate.sweep_state_from_host(jstate.sweep_state_to_host(js),
                                      device="cpu")
    got, n_got = tel.harvest_trailing(ts, r)
    want, n_want = jel.harvest_trailing(js, r)
    assert n_got == n_want == RN - RB
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))


# -- the scheduled elastic driver against the reference ------------------------


@pytest.mark.parametrize("point", R_POINTS[::2], ids=str)
@pytest.mark.parametrize("lane", [0, 3])
def test_shrink_records_equal_reference(point, lane):
    A = _matrix(RP, RM_LOC, RN)
    got, want = _both(A, {point: [lane]}, semantics=Semantics.SHRINK)
    _assert_matches_reference(got, want)
    _gram_ok(A, got.R)
    assert got.world.n_live == RP - 1
    assert [t.kind for t in got.transitions] == ["shrink"]


@pytest.mark.parametrize("point", R_POINTS[1::4], ids=str)
def test_blank_records_equal_reference(point):
    A = _matrix(RP, RM_LOC, RN)
    got, want = _both(A, {point: [2]}, semantics=Semantics.BLANK)
    _assert_matches_reference(got, want)
    _gram_ok(A, got.R)
    (t,) = got.transitions
    assert t.kind == "blank" and t.adopter == 3
    assert got.world.live == (True, True, False, True)


def test_grow_and_two_deaths_equal_reference():
    A = _matrix(RP, RM_LOC, RN)
    got, want = _both(A, {R_POINTS[3]: [1]}, semantics=Semantics.SHRINK,
                      grow_at=(1, "trailing", 1))
    _assert_matches_reference(got, want)
    assert [t.kind for t in got.transitions] == ["shrink", "grow"]
    got, want = _both(A, {R_POINTS[1]: [3], R_POINTS[7]: [0]},
                      semantics=Semantics.SHRINK)
    _assert_matches_reference(got, want)
    assert got.world.n_live == 2


def test_fold_policy_equals_reference():
    A = _matrix(8, 8, 24, seed=11)
    got = tel.ft_caqr_sweep_elastic(
        torch.from_numpy(A), SimComm(8), RB, policy="fold",
        schedule=FailureSchedule(events={(1, "trailing", 2): [5]}))
    want = jel.ft_caqr_sweep_elastic(
        jnp.asarray(A), JSimComm(8), RB, policy="fold",
        schedule=JSchedule(events={(1, "trailing", 2): [5]}))
    _assert_matches_reference(got, want)
    assert got.world.n_slots == 4


def test_elastic_result_crosses_by_interop():
    """A JAX ElasticSweepResult's fields build the port's result, equal to
    the port's own records."""
    A = _matrix(RP, RM_LOC, RN)
    got, want = _both(A, {R_POINTS[4]: [1]}, semantics=Semantics.BLANK)
    moved = interop.elastic_result_from_fields(
        np.asarray(want.R), want.events, want.transitions, want.world,
        device="cpu")
    assert moved.transitions == got.transitions and moved.world == got.world
    assert _ledger(moved.events) == _ledger(got.events)
    np.testing.assert_array_equal(moved.R.numpy(), np.asarray(want.R))


def test_failure_free_elastic_is_exact():
    A = torch.from_numpy(_matrix(RP, RM_LOC, RN))
    res = tel.ft_caqr_sweep_elastic(A, SimComm(RP), RB)
    ref = caqr_factorize(A, SimComm(RP), RB, collect_bundles=True,
                         use_scan=False)
    assert torch.equal(res.R, ref.R[0])
    assert res.transitions == [] and res.events == []


def test_buddy_pair_death_is_unrecoverable():
    A = torch.from_numpy(_matrix(RP, RM_LOC, RN))
    with pytest.raises(UnrecoverableFailure):
        tel.ft_caqr_sweep_elastic(
            A, SimComm(RP), RB, semantics=Semantics.SHRINK,
            schedule=FailureSchedule(events={R_POINTS[2]: [2, 3]}))


# -- scheduled == online, bitwise inside the port -----------------------------


@pytest.mark.parametrize("point", R_POINTS, ids=str)
@pytest.mark.parametrize("semantics", [Semantics.SHRINK, Semantics.BLANK],
                         ids=["shrink", "blank"])
def test_online_bitwise_vs_scheduled(point, semantics):
    A = torch.from_numpy(_matrix(RP, RM_LOC, RN))
    oracle = tel.ft_caqr_sweep_elastic(
        A, SimComm(RP), RB, semantics=semantics,
        schedule=FailureSchedule(events={point: [1]}))
    online = SweepOrchestrator(
        A, SimComm(RP), RB, semantics=semantics,
        fault_hooks=[ScriptedKiller({point: [1]})]).run()
    assert torch.equal(oracle.R, online.R)
    assert oracle.transitions == online.transitions
    assert oracle.world == online.world
    assert _ledger(oracle.events) == _ledger(online.events)


def test_grow_online_bitwise_vs_scheduled():
    A = torch.from_numpy(_matrix(RP, RM_LOC, RN))
    point, grow = R_POINTS[2], (1, "trailing", 0)
    oracle = tel.ft_caqr_sweep_elastic(
        A, SimComm(RP), RB, grow_at=grow,
        schedule=FailureSchedule(events={point: [2]}))
    online = SweepOrchestrator(
        A, SimComm(RP), RB, semantics=Semantics.SHRINK, grow_at=grow,
        fault_hooks=[ScriptedKiller({point: [2]})]).run()
    assert torch.equal(oracle.R, online.R)
    assert [t.kind for t in online.transitions] == ["shrink", "grow"]


def test_fused_online_shrink_equals_scheduled():
    """The fused online path across a transition (K6's plain version on the
    wider second world) equals the stepped scheduled driver bit for bit."""
    A = torch.from_numpy(_matrix(8, 8, 32, seed=5))
    point = (2, "trailing", 2)
    oracle = tel.ft_caqr_sweep_elastic(
        A, SimComm(8), RB, schedule=FailureSchedule(events={point: [3]}))
    orch = SweepOrchestrator(
        A, SimComm(8), RB, semantics=Semantics.SHRINK, fused=True,
        fault_hooks=[ScriptedKiller({point: [3]})])
    online = orch.run()
    assert torch.equal(oracle.R, online.R)
    (t,) = online.transitions
    assert t.world_after.n_slots == 8 and t.world_after.n_live == 7
    assert orch.state.geom.m_loc_pad == 16  # the adopter's slice doubled


# -- ft_caqr_sweep(semantics=...) ---------------------------------------------


@pytest.mark.parametrize("semantics", [Semantics.SHRINK, Semantics.BLANK])
def test_driver_delegates_elastic_semantics(semantics):
    A = _matrix(RP, RM_LOC, RN)
    point = R_POINTS[4]
    got = ft_caqr_sweep(torch.from_numpy(A), SimComm(RP), RB,
                        schedule=FailureSchedule(events={point: [3]}),
                        semantics=semantics)
    want = jel.ft_caqr_sweep_elastic(
        jnp.asarray(A), JSimComm(RP), RB, semantics=JSemantics(semantics.value),
        schedule=JSchedule(events={point: [3]}))
    assert isinstance(got, tel.ElasticSweepResult)
    _assert_matches_reference(got, want)
