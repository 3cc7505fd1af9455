"""The fused paths of the port (``repro_torch.kernels.fused_sweep``): the
whole-panel step ``run_panel_fused`` (K6's plain version on the CPU) and
the fused leaf ``householder.panel_qr_apply`` (K5's).

Inside the port the fusion contract is bitwise: a fused panel boundary
state equals ``panel_points`` sweep_steps, at every boundary, on the
aligned, ragged and wide b = 4 geometries and at b = 160 (above the
128 columns of the card's team body). Against the JAX package's
``fused_panel_math`` and ``panel_qr_apply_ref`` the comparison is within
the f32 tolerance of ``repro.kernels.ref.tolerances``; ``tops`` exactly.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core.householder as jhh
from repro.core import SimComm as JSimComm
from repro.kernels import fused_sweep as jfused
from repro.kernels.ref import tolerances
from repro_torch.core import (
    SimComm,
    caqr_factorize,
    householder,
    pad_to_geometry,
    sweep_geometry,
)
from repro_torch.ft import ScriptedKiller, ft_caqr_sweep_online, sweep_point
from repro_torch.ft.failures import PHASE_LEAF
from repro_torch.ft.online import state as tstate
from repro_torch.kernels import backend, ops, ref
from repro_torch.kernels import fused_sweep as tfused

RTOL, ATOL = tolerances(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this module: under xdist six workers' thread
    teams would spin against each other (``tests/test_torch_moe.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GEOMS = [
    ("aligned", 4, 8, 16, 4),
    ("ragged", 4, 6, 10, 4),
    ("wide", 4, 4, 40, 4),
    # above 128 columns (K5/K6's blocked phases on the card): m_loc_pad 320,
    # a ragged last panel of 80 columns whose root is lane 1
    ("b160", 2, 320, 400, 160),
]


def _matrix(P, m_loc, n, seed=3):
    return np.random.default_rng(seed).standard_normal((P, m_loc, n)).astype(
        np.float32)


def _close(got, want, tag):
    w = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), w, rtol=RTOL,
        atol=ATOL * max(1.0, np.abs(w).max(initial=0)), err_msg=tag)


def _assert_states_bitwise(got, want, tag):
    ga, wa = tstate.flat_arrays(got), tstate.flat_arrays(want)
    assert got.cursor == want.cursor, tag
    assert ga.keys() == wa.keys(), tag
    for key in wa:
        g, w = ga[key], wa[key]
        assert g.dtype == w.dtype and g.device == w.device, (tag, key)
        assert torch.equal(g, w), f"{tag}: {key} differs"


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: g[0])
def test_fused_panel_bitwise_vs_stepped(geom):
    """run_panel_fused == run_steps(comm, state, panel_points(geom)), bit
    for bit at every panel boundary, then an identical finalize."""
    tag, P, m_loc, n, b = geom
    comm = SimComm(P)
    s_stepped = tstate.initial_sweep_state(comm, torch.from_numpy(_matrix(P, m_loc, n)), b)
    s_fused = s_stepped
    pts = tstate.panel_points(s_stepped.geom)
    for k in range(s_stepped.geom.n_panels):
        assert s_fused.cursor == (k, PHASE_LEAF, 0)
        s_fused = tstate.run_panel_fused(comm, s_fused)
        s_stepped = tstate.run_steps(comm, s_stepped, pts)
        _assert_states_bitwise(s_fused, s_stepped, f"{tag}-panel{k}")
    assert s_fused.cursor is None
    for g, w in zip(tstate.finalize(comm, s_fused), tstate.finalize(comm, s_stepped)):
        for x, y in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert torch.equal(x, y), f"{tag}-final"


def test_fused_start_needs_a_leaf_cursor_and_reports_the_plain_engine():
    _, P, m_loc, n, b = GEOMS[0]
    comm = SimComm(P)
    s = tstate.initial_sweep_state(comm, torch.from_numpy(_matrix(P, m_loc, n)), b)
    backend.reset_launches()
    tstate.run_panel_fused(comm, s)
    report = backend.probe_report()["fused_panel"]
    assert report == {"engine": "plain", "launches": 0}
    with pytest.raises(AssertionError):
        tstate.run_panel_fused(comm, tstate.sweep_step(comm, s))


def _windows(geom):
    """Panel k's live window of the padded input, for every k."""
    _, P, m_loc, n, b = geom
    A = _matrix(P, m_loc, n, seed=11)
    g = sweep_geometry(P, m_loc, n, b)
    A_pad = pad_to_geometry(SimComm(P), torch.from_numpy(A), g).numpy()
    return g, [(k, np.ascontiguousarray(A_pad[..., k * b:]))
               for k in range(g.n_panels)]


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: g[0])
def test_fused_panel_math_matches_reference(geom):
    """The port's plain K6 (fused_panel_math over SimComm) against the JAX
    package's fused_panel_math, panel by panel, on the same windows.
    Panel 0 and the last panel: the root lane and the consumed lanes
    differ between them on the aligned and wide geometries."""
    g, wins = _windows(geom)
    L = g.levels
    for k, win in (wins[0], wins[-1]):
        got = tfused.fused_panel_math(SimComm(g.P), torch.from_numpy(win), k,
                                      b=g.b, m_loc_pad=g.m_loc_pad, levels=L)
        want = jfused.fused_panel_math(JSimComm(g.P), jnp.asarray(win), k,
                                       b=g.b, m_loc_pad=g.m_loc_pad, levels=L)
        for f in tfused.FUSED_FIELDS:
            _close(got[f], want[f], f"{geom[0]} panel {k}: {f}")
        assert len(got["tops"]) == len(want["tops"]) == L
        for a, b_ in zip(got["tops"], want["tops"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b_))
        # the ops seam on CPU tensors runs exactly this plain version
        via_ops = ops.fused_panel(torch.from_numpy(win), k, b=g.b,
                                  m_loc_pad=g.m_loc_pad, levels=L)
        assert all(torch.equal(via_ops[f], got[f]) for f in tfused.FUSED_FIELDS)


@pytest.mark.parametrize("m,w,b,row_start", [(8, 16, 4, 0), (12, 20, 4, 5),
                                             (9, 13, 3, 8), (16, 40, 8, 2)])
def test_panel_qr_apply_matches_reference(rng, m, w, b, row_start):
    """The fused leaf entry (CPU: the unfused plain composition) against
    the JAX package's panel_qr_apply_ref and its householder entry; a
    row_start past m - b clamps the C' rows as lax.dynamic_slice does."""
    W = rng.standard_normal((m, w)).astype(np.float32)
    wy, C, Cp = householder.panel_qr_apply(torch.from_numpy(W), row_start, b)
    got = (wy.Y, wy.T, wy.R, C, Cp)
    want = jfused.panel_qr_apply_ref(jnp.asarray(W), row_start, b)
    jwy, jC, jCp = jhh.panel_qr_apply(jnp.asarray(W), jnp.asarray(row_start), b)
    for name, g, w_, w2 in zip("Y T R C C'".split(), got, want,
                               (jwy.Y, jwy.T, jwy.R, jC, jCp)):
        assert tuple(g.shape) == tuple(w_.shape), name
        _close(g, w_, name)
        _close(g, w2, name)
    # lane-batched calls give each lane the bits of a call of it alone
    Wb = torch.from_numpy(np.stack([W, W[::-1].copy(), 2 * W]))
    batched = ops.panel_qr_apply(Wb, row_start, b)
    for lane in range(3):
        alone = ops.panel_qr_apply(Wb[lane], row_start, b)
        assert all(torch.equal(x[lane], y) for x, y in zip(batched, alone))


@pytest.mark.parametrize("row_start", [37, 170, 200])
def test_panel_qr_apply_wide_matches_reference(rng, row_start):
    """The fused leaf's plain version above 128 columns (b = 160 on a
    330 x 400 window) against the JAX package's panel_qr_apply_math; a
    row start of m - b and one past it clamp the C' rows alike."""
    m, w, b = 330, 400, 160
    W = rng.standard_normal((m, w)).astype(np.float32)
    got = ref.panel_qr_apply(torch.from_numpy(W), row_start, b)
    want = jfused.panel_qr_apply_math(jnp.asarray(W), jnp.asarray(row_start), b=b)
    for name, g, w_ in zip("Y T R C C'".split(), got, want):
        assert tuple(g.shape) == tuple(w_.shape), name
        _close(g, w_, f"b=160 row_start={row_start}: {name}")


def test_online_fused_equals_stepped_at_b160():
    """The orchestrator at panel width 160 with fused segments (one K6 a
    panel) against the stepped one, with a panel-end kill of lane 1 in
    panel 0: R, factors, bundles and the ledger bit for bit; the killed
    run within tolerance of the failure-free sweep (bit for bit on the
    card; torch's CPU products change their last bits with the batch, and
    the REBUILD replays one lane alone), the failure-free fused run bit for
    bit."""
    _, P, m_loc, n, b = GEOMS[-1]
    A = torch.from_numpy(_matrix(P, m_loc, n, seed=5))
    kills = {sweep_point(0, "trailing", 0): [1]}
    runs = [ft_caqr_sweep_online(A, SimComm(P), b, fused=fused,
                                 fault_hooks=[ScriptedKiller(kills)])
            for fused in (True, False)]
    clean = caqr_factorize(A, SimComm(P), b, collect_bundles=True,
                           use_scan=False)
    flat = [(r.R, *r.factors, *r.bundles) for r in (*runs, clean)]
    assert len(flat[0]) == len(flat[1]) == len(flat[2])
    assert all(torch.equal(x, y) for x, y in zip(flat[0], flat[1]))
    for x, y in zip(flat[0], flat[2]):
        _close(x, y, "killed against failure-free")
    ledgers = [[(tuple(e.point), e.lane) for e in r.events] for r in runs]
    assert ledgers[0] == ledgers[1] == [((0, "trailing", 0), 1)]
    free = ft_caqr_sweep_online(A, SimComm(P), b, fused=True)
    assert all(torch.equal(x, y) for x, y in
               zip((free.R, *free.factors, *free.bundles), flat[2]))


@pytest.mark.parametrize("P", [2, 4, 8, 16])
def test_tops_match_reference(P):
    L = P.bit_length() - 1
    for t_lane in range(P):
        got = tfused._tops(P, t_lane, L)
        want = jfused._tops(P, t_lane, L)
        assert len(got) == len(want) == L
        for a, b in zip(got, want):
            assert a.dtype == torch.bool
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
