"""The port's sweep state machine (``repro_torch.ft.online.state``) and
cursor algebra (``repro_torch.ft.failures``) against the JAX package.

Discrete outputs (cursor sequence, geometry, wire-format keys and meta,
integer and bool leaves) must match exactly; float leaves within the f32
pair of ``repro.kernels.ref.tolerances``, scaled by max(1, max|JAX|),
since the two frameworks group their reductions differently. The bitwise
claims are the port's own: stepping equals the port's ``caqr_factorize``,
and no transition changes the state it is given.
"""
import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import SimComm as JSimComm
from repro.ft import failures as jfail
from repro.ft.online import state as jstate
from repro.kernels.ref import tolerances
from repro_torch.core import SimComm, caqr_factorize
from repro_torch.ft import failures as tfail
from repro_torch.ft.online import state as tstate

RTOL, ATOL = tolerances(np.float32)

# (tag, P, m_loc, n, b): the reference tests' b = 4 geometry classes
GEOMS = [
    ("aligned", 4, 8, 16, 4),
    ("ragged", 4, 6, 10, 4),
    ("wide", 4, 4, 40, 4),
]


def _matrix(P, m_loc, n, seed=3):
    return np.random.default_rng(seed).standard_normal((P, m_loc, n)).astype(
        np.float32)


def _assert_host_close(got, want, tag):
    """Two wire-format dicts: same keys and meta, exact non-float leaves,
    float leaves within tolerance."""
    assert got.keys() == want.keys(), tag
    assert json.loads(str(got["__meta__"])) == json.loads(str(want["__meta__"])), tag
    for key in want:
        if key == "__meta__":
            continue
        g, w = got[key], np.asarray(want[key])
        assert g.dtype == w.dtype and g.shape == w.shape, (tag, key)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(
                g, w, rtol=RTOL, atol=ATOL * max(1.0, np.abs(w).max(initial=0)),
                err_msg=f"{tag}: {key}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{tag}: {key}")


def _assert_close(got, want, tag):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=RTOL,
            atol=ATOL * max(1.0, np.abs(w).max(initial=0)), err_msg=tag)


def _flatten(res):
    R, factors, bundles = res
    return (R, *factors, *bundles)


@pytest.mark.parametrize("levels", [1, 2, 3])
@pytest.mark.parametrize("n_panels", [1, 2, 4])
def test_cursor_algebra_matches_reference(n_panels, levels):
    pts = list(tfail.iter_sweep_points(n_panels, levels))
    assert pts == list(jfail.iter_sweep_points(n_panels, levels))
    assert len(pts) == n_panels * (1 + 2 * levels)
    for p in pts + [None]:
        if p is not None:
            assert (tfail.next_sweep_point(p, n_panels, levels)
                    == jfail.next_sweep_point(p, n_panels, levels))
        assert (tfail.prev_sweep_point(p, n_panels, levels)
                == jfail.prev_sweep_point(p, n_panels, levels))
    for phase in tfail.SWEEP_PHASES:
        assert tfail.sweep_point(2, phase, 1) == jfail.sweep_point(2, phase, 1)
    # the detector fires each scheduled death once and forgets revived lanes
    for mod in (tfail, jfail):
        d = mod.Detector(4, mod.FailureSchedule(events={pts[-1]: [1, 2]}))
        assert d.begin_step(pts[-1]) == [1, 2] and d.begin_step(pts[-1]) == []
        d.revive(1)
        assert sorted(d.dead) == [2]
        with pytest.raises(mod.LaneFailure):
            d.check((0, 2), pts[-1])


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: g[0])
def test_every_boundary_state_matches_reference(geom):
    """Lockstep: after every sweep_step the port's state equals the JAX
    package's in the wire format (keys, geometry, cursor exact; floats
    within tolerance), and so do the finalized outputs."""
    tag, P, m_loc, n, b = geom
    A = _matrix(P, m_loc, n)
    jc, tc = JSimComm(P), SimComm(P)
    js = jstate.initial_sweep_state(jc, jnp.asarray(A), b)
    ts = tstate.initial_sweep_state(tc, torch.from_numpy(A), b)
    assert tuple(ts.geom) == tuple(js.geom)
    while js.cursor is not None:
        assert ts.cursor == js.cursor
        js, ts = jstate.sweep_step(jc, js), tstate.sweep_step(tc, ts)
        _assert_host_close(tstate.sweep_state_to_host(ts),
                           jstate.sweep_state_to_host(js), f"{tag}@{js.cursor}")
    assert ts.cursor is None
    _assert_close(_flatten(tstate.finalize(tc, ts)),
                  _flatten(jstate.finalize(jc, js)), f"{tag}: finalize")


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: g[0])
def test_stepped_equals_caqr_factorize_bitwise(geom):
    tag, P, m_loc, n, b = geom
    A = torch.from_numpy(_matrix(P, m_loc, n, seed=5))
    comm = SimComm(P)
    ref = caqr_factorize(A, comm, b, collect_bundles=True, use_scan=False)
    s = tstate.run_steps(comm, tstate.initial_sweep_state(comm, A, b))
    got = _flatten(tstate.finalize(comm, s))
    want = _flatten((ref.R, ref.factors, ref.bundles))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), tag


# Points of the ragged sweep (15 in all) at which a state is handed over:
# after the leaf, mid-butterfly, mid-trailing, at a panel boundary with the
# deposit still pending, and past the end.
RESUME_AFTER = [1, 3, 5, 10, 15]


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("steps", RESUME_AFTER)
def test_jax_state_resumes_in_port(steps, version):
    _, P, m_loc, n, b = GEOMS[1]
    A = _matrix(P, m_loc, n, seed=7)
    jc, tc = JSimComm(P), SimComm(P)
    js = jstate.run_steps(jc, jstate.initial_sweep_state(jc, jnp.asarray(A), b),
                          steps)
    ts = tstate.sweep_state_from_host(
        jstate.sweep_state_to_host(js, version=version), device="cpu")
    assert ts.cursor == js.cursor and tuple(ts.geom) == tuple(js.geom)
    got = tstate.finalize(tc, tstate.run_steps(tc, ts))
    want = jstate.finalize(jc, jstate.run_steps(jc, js))
    _assert_close(_flatten(got), _flatten(want), f"resume after {steps}")


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("steps", RESUME_AFTER)
def test_port_state_resumes_in_jax(steps, version):
    _, P, m_loc, n, b = GEOMS[1]
    A = _matrix(P, m_loc, n, seed=7)
    jc, tc = JSimComm(P), SimComm(P)
    ts = tstate.run_steps(tc, tstate.initial_sweep_state(tc, torch.from_numpy(A), b),
                          steps)
    js = jstate.sweep_state_from_host(
        tstate.sweep_state_to_host(ts, version=version))
    assert js.cursor == ts.cursor
    got = jstate.finalize(jc, jstate.run_steps(jc, js))
    want = tstate.finalize(tc, tstate.run_steps(tc, ts))
    _assert_close(_flatten(got), [x.numpy() for x in _flatten(want)],
                  f"resume after {steps}")


@pytest.mark.parametrize("version", [1, 2])
def test_wire_format_round_trip_is_exact(version):
    _, P, m_loc, n, b = GEOMS[0]
    comm = SimComm(P)
    s = tstate.initial_sweep_state(comm, torch.from_numpy(_matrix(P, m_loc, n)), b)
    for steps in (0, 2, 4, 6):
        s = tstate.run_steps(comm, s, steps)
        back = tstate.sweep_state_from_host(
            tstate.sweep_state_to_host(s, version=version), device="cpu")
        a, c = tstate.flat_arrays(s), tstate.flat_arrays(back)
        assert back.cursor == s.cursor and back.geom == s.geom
        assert a.keys() == c.keys()
        assert all(a[k].dtype == c[k].dtype and torch.equal(a[k].cpu(), c[k])
                   for k in a)


def _snapshot(state):
    return {k: v.clone() for k, v in tstate.flat_arrays(state).items()}


def _unchanged(state, snap):
    now = tstate.flat_arrays(state)
    return now.keys() == snap.keys() and all(
        torch.equal(now[k], snap[k]) for k in snap)


def test_transitions_do_not_change_their_input_state():
    """The deposit writes C' back into a fresh tensor: ``sweep_step`` (with
    the deferred deposit), ``run_panel_fused``, ``deposit_boundary`` and
    ``finalize`` leave the state they are given as it was."""
    _, P, m_loc, n, b = GEOMS[0]
    comm = SimComm(P)
    s0 = tstate.initial_sweep_state(comm, torch.from_numpy(_matrix(P, m_loc, n)), b)
    pts = tstate.panel_points(s0.geom)
    s = tstate.run_steps(comm, s0, pts)        # cursor at (1, leaf): deposit pending
    assert s.cursor == (1, "leaf", 0)
    snap = _snapshot(s)
    tstate.sweep_step(comm, s)
    assert _unchanged(s, snap)
    tstate.run_panel_fused(comm, s)
    assert _unchanged(s, snap)
    deposited, r = tstate.deposit_boundary(comm, s)
    assert r == 1 and _unchanged(s, snap)
    assert not torch.equal(deposited.A, s.A)   # the writeback did happen
    end = tstate.run_steps(comm, s)
    snap = _snapshot(end)
    first = tstate.finalize(comm, end)
    assert _unchanged(end, snap)
    second = tstate.finalize(comm, end)
    assert all(torch.equal(x, y) for x, y in zip(_flatten(first), _flatten(second)))
    tstate.deposit_boundary(comm, end)
    assert _unchanged(end, snap)


def test_lane_axes_mirror_the_state():
    _, P, m_loc, n, b = GEOMS[0]
    comm = SimComm(P)
    s = tstate.initial_sweep_state(comm, torch.from_numpy(_matrix(P, m_loc, n)), b)
    s = tstate.run_steps(comm, s, tstate.panel_points(s.geom) + 4)
    axes = tstate.state_lane_axes(s)
    assert axes.level_Y2 == 1 and axes.A == 0 and axes.code is None
    assert axes.factors[0].level_Y2 == 1 and axes.bundles[0].W == 1
    assert len(axes.Y2s) == len(s.Y2s)
    flat_s, flat_a = tstate.flat_arrays(s), tstate.flat_arrays(axes)
    assert flat_s.keys() == flat_a.keys()
    for k, ax in flat_a.items():
        assert flat_s[k].shape[ax] == P, k
