"""The port's online recovery (``repro_torch.ft.online``: detectors, the
orchestrator; ``repro_torch.ckpt``: sweep checkpoints and the diskless
stores) against the JAX package, mirroring ``tests/test_online_recovery.py``.

Inside the port the claims are bitwise, torch against torch: online ==
scheduled == failure-free, async == sync, fused == stepped. Against the
JAX package: the ``RecoveryEvent`` ledgers (point, lane, reads), the
strike points and the ``SpeculationEvent``s exactly; R within the f32
pair of ``repro.kernels.ref.tolerances``.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.ckpt as jckpt
import repro.ft as jft
from repro.ckpt import diskless as jdiskless
from repro.core import SimComm as JSimComm
from repro.ft.online import detect as jdetect
from repro.ft.online import state as jstate
from repro.kernels.ref import tolerances
from repro_torch.ckpt import diskless, load_sweep_state, save_sweep_state
from repro_torch.core import SimComm, caqr_factorize, sweep_geometry
from repro_torch.ft import (
    DelayedDetector,
    FailureSchedule,
    LaneFailure,
    MDSScheme,
    NaNSentinelDetector,
    ScriptedKiller,
    Semantics,
    StragglerConfig,
    StragglerMonitor,
    StragglerPolicy,
    SweepOrchestrator,
    UnrecoverableFailure,
    WallClockKiller,
    compiled_segment,
    ft_caqr_sweep,
    ft_caqr_sweep_online,
    iter_sweep_points,
    sweep_point,
)
from repro_torch.ft.online import detect as tdetect
from repro_torch.ft.online import state as tstate

RTOL, ATOL = tolerances(np.float32)

# the ragged geometry: unaligned lane heights and a ragged last panel
RP, RM_LOC, RN, RB = 4, 6, 10, 4
RGEOM = sweep_geometry(RP, RM_LOC, RN, RB)
R_POINTS = list(iter_sweep_points(RGEOM.n_panels, RGEOM.levels))


def _matrix(P=RP, m_loc=RM_LOC, n=RN, seed=3):
    return np.random.default_rng(seed).standard_normal((P, m_loc, n)).astype(
        np.float32)


def _flat(res):
    return (res.R, *res.factors, *res.bundles)


def _assert_bitwise(got, want, tag=""):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        assert x.dtype == y.dtype and torch.equal(x, y), tag


def _ledger(events):
    return [(tuple(e.point), e.lane, dict(e.reads)) for e in events]


def _assert_close(got, want):
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(w).max()))


def _jax_scheduled(A, kills, P=RP, b=RB):
    return jft.ft_caqr_sweep(jnp.asarray(A), JSimComm(P), b,
                             schedule=jft.FailureSchedule(events=kills))


@pytest.fixture(scope="module")
def ragged():
    A = _matrix()
    ref = caqr_factorize(torch.from_numpy(A), SimComm(RP), RB,
                         collect_bundles=True, use_scan=False)
    return A, ref


def _online(A, kills, P=RP, b=RB, **kw):
    return ft_caqr_sweep_online(torch.from_numpy(A), SimComm(P), b,
                                fault_hooks=[ScriptedKiller(kills)], **kw)


# -- failure-free ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(fused=True),
                                dict(async_segments=True),
                                dict(jit_segments=False),
                                dict(segment_points=4, async_segments=True)],
                         ids=["stepped", "fused", "async", "eager", "async4"])
def test_failure_free_online_equals_ft_caqr_sweep(ragged, kw):
    A, ref = ragged
    orch = SweepOrchestrator(torch.from_numpy(A), SimComm(RP), RB, **kw)
    got = orch.run()
    _assert_bitwise(got, ft_caqr_sweep(torch.from_numpy(A), SimComm(RP), RB))
    _assert_bitwise(got, ref)
    assert got.events == []
    per = kw.get("segment_points", 1)
    want = RGEOM.n_panels if kw.get("fused") else -(-len(R_POINTS) // per)
    assert orch.segments_run == orch.boundaries == want


def test_compiled_segment_is_shared():
    fn = compiled_segment(SimComm(RP), 2)
    assert compiled_segment(SimComm(RP), 2) is fn
    assert compiled_segment(SimComm(RP), 3) is not fn


# -- the online kill matrices -------------------------------------------------------


@pytest.mark.parametrize("lane", [0, 1, 3])
@pytest.mark.parametrize("point", R_POINTS,
                         ids=lambda p: f"p{p[0]}-{p[1]}{p[2]}")
def test_online_kill_matrix_ragged(ragged, point, lane):
    """A runtime kill at every point of the ragged sweep, found by the NaN
    sentinel: bit-identical to the port's scheduled kill and to the
    failure-free sweep, with the JAX package's ledger."""
    A, ref = ragged
    got = _online(A, {point: [lane]})
    _assert_bitwise(got, ref)
    sched = ft_caqr_sweep(torch.from_numpy(A), SimComm(RP), RB,
                          schedule=FailureSchedule(events={point: [lane]}))
    assert _ledger(got.events) == _ledger(sched.events)
    assert _ledger(got.events) == _ledger(
        _jax_scheduled(A, {point: [lane]}).events)
    (event,) = got.events
    assert event.point == point and event.lane == lane


@pytest.mark.parametrize("lane", range(4))
def test_online_kill_matrix_aligned_exhaustive(lane):
    """Every point of the aligned 4 x (8 x 16) sweep for one lane: online
    == failure-free bitwise, and the ledger equals JAX's."""
    P, m_loc, n, b = 4, 8, 16, 4
    A = _matrix(P, m_loc, n, seed=0)
    ref = caqr_factorize(torch.from_numpy(A), SimComm(P), b,
                         collect_bundles=True, use_scan=False)
    for point in iter_sweep_points(n // b, 2):
        got = _online(A, {point: [lane]}, P=P, b=b)
        _assert_bitwise(got, ref, str(point))
        assert _ledger(got.events) == _ledger(
            _jax_scheduled(A, {point: [lane]}, P=P, b=b).events), point


@pytest.mark.parametrize("kills", [
    {sweep_point(0, "trailing", 1): [2], sweep_point(1, "tsqr", 0): [1]},
    {sweep_point(1, "trailing", 0): [2], sweep_point(1, "trailing", 1): [2]},
    {sweep_point(1, "trailing", 0): [0, 3]},
], ids=["two-panels", "same-lane-twice", "non-buddy-pair"])
def test_several_deaths(ragged, kills):
    A, ref = ragged
    got = _online(A, kills)
    _assert_bitwise(got, ref)
    assert _ledger(got.events) == _ledger(_jax_scheduled(A, kills).events)
    assert len(got.events) == 2


def test_buddy_pair_death_raises_in_both(ragged):
    A, _ = ragged
    point = sweep_point(1, "trailing", 0)
    with pytest.raises(UnrecoverableFailure):
        _online(A, {point: [2, 3]})
    with pytest.raises(jft.UnrecoverableFailure):
        jft.ft_caqr_sweep_online(
            jnp.asarray(A), JSimComm(RP), RB,
            fault_hooks=[jdetect.ScriptedKiller({point: [2, 3]})])


def test_rebuilt_state_carries_no_nan(ragged):
    A, _ = ragged
    kills = {sweep_point(1, "trailing", 0): [2], sweep_point(2, "tsqr", 1): [0]}
    seen = []

    def audit(orch):
        seen.append(tdetect._deep_nan_lanes(orch.comm, orch.state))

    SweepOrchestrator(torch.from_numpy(A), SimComm(RP), RB,
                      fault_hooks=[ScriptedKiller(kills)],
                      boundary_hooks=[audit]).run()
    assert len(seen) == len(R_POINTS) and not any(seen)


# -- detectors ----------------------------------------------------------------


def test_false_negative_one_segment_late(ragged):
    """The detector misses the death once; it surfaces at the next
    boundary and is attributed there, as JAX attributes it."""
    A, ref = ragged
    kill = {sweep_point(0, "trailing", 1): [2]}
    got = _online(A, kill, detector=DelayedDetector(NaNSentinelDetector()))
    _assert_bitwise(got, ref)
    want = jft.ft_caqr_sweep_online(
        jnp.asarray(A), JSimComm(RP), RB,
        detector=jdetect.DelayedDetector(jdetect.NaNSentinelDetector()),
        fault_hooks=[jdetect.ScriptedKiller(kill)])
    assert _ledger(got.events) == _ledger(want.events)
    assert got.events[0].point == sweep_point(1, "leaf")


@pytest.mark.parametrize("delay", [0, 1])
def test_fail_stop_detector_report_delay(ragged, delay):
    """Declared deaths surface after ``report_delay`` polls, at the same
    boundary as in the JAX package."""
    A, ref = ragged
    point = sweep_point(0, "trailing", 1) if delay else \
        sweep_point(1, "trailing", 1)

    def run(mod_detect, entry, comm, A_):
        det = mod_detect.FailStopDetector(report_delay=delay)
        killer = mod_detect.ScriptedKiller({point: [3]})

        def kill_and_declare(c, state):
            before = len(killer._fired)
            state = killer(c, state)
            if len(killer._fired) > before:
                det.declare(3)
            return state

        return entry(A_, comm, RB, detector=det,
                     fault_hooks=[kill_and_declare])

    got = run(tdetect, ft_caqr_sweep_online, SimComm(RP), torch.from_numpy(A))
    _assert_bitwise(got, ref)
    want = run(jdetect, jft.ft_caqr_sweep_online, JSimComm(RP), jnp.asarray(A))
    assert _ledger(got.events) == _ledger(want.events)
    assert len(got.events) == 1


def test_deep_scan(ragged):
    A, ref = ragged
    point = sweep_point(2, "tsqr", 1)
    got = _online(A, {point: [1]}, detector=NaNSentinelDetector(deep=True))
    _assert_bitwise(got, ref)
    assert [(e.point, e.lane) for e in got.events] == [(point, 1)]


def test_probe_and_collect_report_once():
    comm = SimComm(RP)
    s = tstate.run_steps(comm, tstate.initial_sweep_state(
        comm, torch.from_numpy(_matrix()), RB), 3)
    det = NaNSentinelDetector()
    assert det.collect(comm, det.probe(comm, s)) == []
    struck = ScriptedKiller({sweep_point(0, "tsqr", 1): [2]})(comm, s)
    assert det.collect(comm, det.probe(comm, struck)) == [2]
    assert det.poll(comm, struck) == []          # reported once
    det.revive(2)
    assert det.poll(comm, struck) == [2]         # re-armed
    det.reset()
    assert det.poll(comm, struck) == [2]
    assert NaNSentinelDetector(deep=True).poll(comm, struck) == [2]


# -- segments, ABORT, the wall clock ---------------------------------------------


def test_segmented_execution_and_boundary_kill(ragged):
    A, ref = ragged
    orch = SweepOrchestrator(torch.from_numpy(A), SimComm(RP), RB,
                             segment_points=3)
    _assert_bitwise(orch.run(), ref)
    assert orch.segments_run == -(-len(R_POINTS) // 3)
    point = R_POINTS[2]
    got = _online(A, {point: [1]}, segment_points=3)
    _assert_bitwise(got, ref)
    assert _ledger(got.events) == _ledger(
        _jax_scheduled(A, {point: [1]}).events)


def test_abort_semantics_raises(ragged):
    A, _ = ragged
    with pytest.raises(LaneFailure):
        _online(A, {sweep_point(0, "tsqr", 0): [1]}, semantics=Semantics.ABORT)


def test_wall_clock_killer(ragged, fake_clock):
    """The kill lands where the clock says, at the same point as in the
    JAX package with the same fake clock, and recovers bitwise."""
    from conftest import FakeClock

    A, ref = ragged
    killer = WallClockKiller(after_s=3.0, lane=2, clock=fake_clock)
    got = ft_caqr_sweep_online(torch.from_numpy(A), SimComm(RP), RB,
                               fault_hooks=[killer])
    _assert_bitwise(got, ref)
    assert killer.struck_at == R_POINTS[3]
    jkill = jdetect.WallClockKiller(after_s=3.0, lane=2, clock=FakeClock())
    want = jft.ft_caqr_sweep_online(jnp.asarray(A), JSimComm(RP), RB,
                                    fault_hooks=[jkill])
    assert jkill.struck_at == killer.struck_at
    assert _ledger(got.events) == _ledger(want.events)


# -- async == sync, fused == stepped ----------------------------------------------


@pytest.mark.parametrize("scheme", [None, MDSScheme(f=2)], ids=["xor", "mds"])
def test_async_equals_sync(ragged, scheme):
    A, ref = ragged
    kills = {sweep_point(0, "trailing", 1): [2], sweep_point(2, "leaf"): [1]}
    if scheme is not None:
        kills[sweep_point(1, "tsqr", 1)] = [2, 3]
    sync = _online(A, kills, scheme=scheme)
    orch = SweepOrchestrator(torch.from_numpy(A), SimComm(RP), RB,
                             scheme=scheme, async_segments=True,
                             fault_hooks=[ScriptedKiller(kills)])
    asy = orch.run()
    _assert_bitwise(asy, sync)
    _assert_bitwise(asy, ref)
    assert _ledger(asy.events) == _ledger(sync.events)
    assert orch.segments_run == len(R_POINTS)


def test_fused_equals_stepped_online(ragged):
    A, ref = ragged
    L = RGEOM.levels
    kills = {sweep_point(0, "trailing", L - 1): [1],
             sweep_point(1, "trailing", L - 1): [2, 3]}
    fused = _online(A, kills, fused=True, scheme=MDSScheme(f=2))
    stepped = _online(A, kills, scheme=MDSScheme(f=2))
    _assert_bitwise(fused, stepped)
    _assert_bitwise(fused, ref)
    assert _ledger(fused.events) == _ledger(stepped.events)
    assert _ledger(fused.events) == _ledger(jft.ft_caqr_sweep(
        jnp.asarray(A), JSimComm(RP), RB, scheme=jft.MDSScheme(f=2),
        schedule=jft.FailureSchedule(events=kills)).events)


# -- suspend / persist / resume -------------------------------------------------


def test_suspend_resume_npz_round_trip(tmp_path, ragged):
    A, ref = ragged
    comm = SimComm(RP)
    s = tstate.run_steps(comm, tstate.initial_sweep_state(
        comm, torch.from_numpy(A), RB), 7)
    path = save_sweep_state(os.path.join(str(tmp_path), "mid_sweep"), s)
    assert path.endswith(".npz")
    back = load_sweep_state(path, device="cpu")
    assert back.cursor == s.cursor and back.geom == s.geom
    _assert_bitwise(SweepOrchestrator.from_state(back, SimComm(RP)).run(), ref)


def test_port_npz_loads_in_jax(tmp_path, ragged):
    A, _ = ragged
    comm = SimComm(RP)
    s = tstate.run_steps(comm, tstate.initial_sweep_state(
        comm, torch.from_numpy(A), RB), 4)
    path = save_sweep_state(os.path.join(str(tmp_path), "port"), s)
    js = jckpt.load_sweep_state(path)
    assert js.cursor == s.cursor and tuple(js.geom) == tuple(s.geom)
    want = jft.SweepOrchestrator.from_state(js, JSimComm(RP)).run()
    got = SweepOrchestrator.from_state(s, comm).run()
    _assert_close(got.R, want.R)


@pytest.mark.parametrize("scheme", ["xor", "mds"])
def test_jax_npz_resumes_in_port_with_a_kill(tmp_path, ragged, scheme):
    """A JAX-written npz (with MDS parity under "mds") resumes in the
    port; a kill after the resume (a buddy pair at the resume boundary
    under "mds") gives JAX's ledger exactly and R within tolerance. The
    joint decode restores the persisted bytes, so under "mds" the port's
    result also equals its own resume without the kill, bit for bit; a
    REBUILD replays the JAX-computed panels through the port's kernels,
    so under "xor" it is held within tolerance only."""
    A, ref = ragged
    jc = JSimComm(RP)
    js = jstate.run_steps(jc, jstate.initial_sweep_state(
        jc, jnp.asarray(A), RB), 5)
    if scheme == "mds":
        js = jft.MDSScheme(f=2).refresh(jc, js)
        kills, t_scheme, j_scheme = ({R_POINTS[4]: [2, 3]}, MDSScheme(f=2),
                                     jft.MDSScheme(f=2))
    else:
        kills, t_scheme, j_scheme = ({sweep_point(2, "trailing", 0): [0]},
                                     None, None)
    path = jckpt.save_sweep_state(os.path.join(str(tmp_path), "jax"), js)
    ts = load_sweep_state(path, device="cpu")
    got = SweepOrchestrator.from_state(
        ts, SimComm(RP), scheme=t_scheme,
        fault_hooks=[ScriptedKiller(kills)]).run()
    want = jft.SweepOrchestrator.from_state(
        jckpt.load_sweep_state(path), jc, scheme=j_scheme,
        fault_hooks=[jdetect.ScriptedKiller(kills)]).run()
    assert _ledger(got.events) == _ledger(want.events)
    assert len(got.events) == (2 if scheme == "mds" else 1)
    _assert_close(got.R, want.R)
    clean = SweepOrchestrator.from_state(ts, SimComm(RP)).run()
    if scheme == "mds":
        _assert_bitwise(got, clean)
    else:
        _assert_close(got.R, clean.R.numpy())


def test_suspend_resume_with_failure_after_resume(tmp_path, ragged):
    A, ref = ragged
    comm = SimComm(RP)
    s = tstate.run_steps(comm, tstate.initial_sweep_state(
        comm, torch.from_numpy(A), RB), 4)
    path = save_sweep_state(os.path.join(str(tmp_path), "mid"), s, version=1)
    point = sweep_point(2, "trailing", 0)
    got = SweepOrchestrator.from_state(
        load_sweep_state(path, device="cpu"), SimComm(RP),
        fault_hooks=[ScriptedKiller({point: [0]})]).run()
    _assert_bitwise(got, ref)
    assert [(e.point, e.lane) for e in got.events] == [(point, 0)]


def test_diskless_store_snapshot_and_restore(ragged):
    A, ref = ragged
    store = diskless.SweepStateStore(keep=2)
    SweepOrchestrator(torch.from_numpy(A), SimComm(RP), RB, store=store,
                      persist_every=4).run()
    assert len(store) == 2
    assert store.restore().cursor is None  # the final boundary is pushed
    mid = store.restore(back=1)
    assert mid.cursor is not None
    _assert_bitwise(SweepOrchestrator.from_state(mid, SimComm(RP)).run(), ref)


def test_buddy_and_parity_stores_equal_reference():
    rng = np.random.default_rng(1)
    lanes = [{"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": (rng.standard_normal(4).astype(np.float32),
                    rng.integers(0, 9, 2).astype(np.int32))}
             for _ in range(8)]
    tlanes = [{"w": torch.from_numpy(x["w"]), "b": x["b"]} for x in lanes]
    tb, jb = diskless.BuddyStore(8), jdiskless.BuddyStore(8)
    for i in range(8):
        tb.push(i, tlanes[i])
        jb.push(i, lanes[i])
    got, want = tb.recover(5), jb.recover(5)
    assert np.array_equal(got["w"], want["w"])
    assert np.array_equal(got["w"], lanes[5]["w"])
    tp, jp = diskless.ParityStore(8, group=4), jdiskless.ParityStore(8, group=4)
    tp.push_group(tlanes)
    jp.push_group(lanes)
    for failed in (0, 6):
        got, want = tp.recover(failed), jp.recover(failed)
        for g, w, x in ((got["w"], want["w"], lanes[failed]["w"]),
                        (got["b"][0], want["b"][0], lanes[failed]["b"][0]),
                        (got["b"][1], want["b"][1], lanes[failed]["b"][1])):
            assert np.array_equal(g, np.asarray(w)) and np.array_equal(g, x)


# -- stragglers -----------------------------------------------------------------


def _slow_clock(slow, m_loc=None):
    def clock(comm, state):
        P = comm.axis_size()
        hit = slow if m_loc is None or state.geom.m_loc == m_loc else -1
        return {i: (8.0 if i == hit else 1.0) for i in range(P)}

    return clock


def _races(speculations):
    """(point, lane, reads) of each SpeculationEvent. ``matched`` is the
    bitwise comparison of a lane with its own recompute inside one
    package; the JAX package's depends on the host CPU (it is one of the
    host-dependent bitwise cells), so the port's is held to True on its
    own."""
    return [(tuple(s.point), s.lane, dict(s.reads)) for s in speculations]


def _both_orchestrators(A, cfg, clock, P=4, b=4):
    """The port's and JAX's orchestrators with the same straggler config
    and lane clock; returns both after run() with their results."""
    tcfg = StragglerConfig(**cfg)
    jcfg = jft.StragglerConfig(**{**cfg, "policy": jft.StragglerPolicy(
        cfg["policy"].value)})
    t = SweepOrchestrator(torch.from_numpy(A), SimComm(P), b,
                          straggler_monitor=StragglerMonitor(P, tcfg),
                          lane_clock=clock)
    j = jft.SweepOrchestrator(jnp.asarray(A), JSimComm(P), b,
                              straggler_monitor=jft.StragglerMonitor(P, jcfg),
                              lane_clock=clock)
    return t, t.run(), j, j.run()


def test_speculation_events_equal_reference():
    """A persistently slow lane triggers speculative buddy recomputes: the
    port's SpeculationEvents equal JAX's, every one bit-matched, and R and
    the ledger stay the failure-free result."""
    P, m_loc, n, b = 4, 8, 16, 4
    A = _matrix(P, m_loc, n, seed=0)
    t, got, j, _ = _both_orchestrators(
        A, dict(threshold=1.4, patience=2, policy=StragglerPolicy.SPECULATE),
        _slow_clock(2))
    assert t.speculations, "the slow lane never triggered a speculation"
    assert _races(t.speculations) == _races(j.speculations)
    assert all(s.matched and s.lane == 2 and s.reads for s in t.speculations)
    ref = caqr_factorize(torch.from_numpy(A), SimComm(P), b,
                         collect_bundles=True, use_scan=False)
    _assert_bitwise(got, ref)
    assert got.events == []


@pytest.mark.parametrize("cfg", [
    dict(threshold=1.4, patience=2, policy=StragglerPolicy.EVICT),
    dict(threshold=1.4, patience=2, policy=StragglerPolicy.SPECULATE,
         escalate_after=2),
], ids=["evict", "escalate"])
def test_eviction_escalates_to_shrink_as_reference(cfg):
    P, m_loc, n, b = 4, 8, 16, 4
    A = _matrix(P, m_loc, n, seed=0)
    t, got, j, want = _both_orchestrators(A, cfg, _slow_clock(1, m_loc))
    assert _races(t.speculations) == _races(j.speculations)
    assert all(s.matched for s in t.speculations)
    assert [(x.kind, x.frontier, x.lanes, x.adopter) for x in got.transitions] \
        == [(x.kind, x.frontier, x.lanes, x.adopter) for x in want.transitions]
    assert [x.kind for x in got.transitions] == ["shrink"]
    assert got.world.n_live == P - 1
    assert _ledger(got.events) == _ledger(want.events)
    _assert_close(got.R, want.R)
