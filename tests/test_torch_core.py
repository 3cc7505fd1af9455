"""The port's core modules (``repro_torch.core``) against the JAX package on
the same numpy inputs: comm, householder, tsqr, trailing, caqr, lstsq.

Floats within ``atol = 3e-4 * max(1, max|ref|)`` (the JAX package's f32
tolerance); geometry, ``active``, ``target``, ``row_start`` and
``self_was_top`` exactly. On this CPU the port runs its plain kernel
versions.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
from repro.core import lstsq as jlstsq
import repro_torch.core as T
from repro_torch.core import lstsq as tlstsq

TOL = 3e-4
EXACT = {"row_start", "active", "target", "self_was_top"}


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, exact=False):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if exact:
        np.testing.assert_array_equal(g, w)
        return
    w = w.astype(np.float64)
    np.testing.assert_allclose(g.astype(np.float64), w, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(w).max(initial=0)))


def close_tuple(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for f in want._fields:
        close(getattr(got, f), getattr(want, f), exact=f in EXACT)


# -- comm ---------------------------------------------------------------------


def test_simcomm_primitives_match_reference(rng):
    P = 4
    x = rng.standard_normal((P, 3, 2)).astype(np.float32)
    tc, jc = T.SimComm(P), J.SimComm(P)
    perm = [(0, 2), (3, 1)]
    close(tc.ppermute(t(x), perm), jc.ppermute(jnp.asarray(x), perm), exact=True)
    xor = [(i, i ^ 1) for i in range(P)]
    close(tc.ppermute(t(x), xor), jc.ppermute(jnp.asarray(x), xor), exact=True)
    close(tc.psum(t(x)), jc.psum(jnp.asarray(x)))
    cond = np.array([True, False, True, False])
    close(tc.where(t(cond), t(x), t(-x)), jc.where(cond, x, -x), exact=True)
    close(tc.where_lane(2, t(x), t(-x)), jc.where_lane(2, x, -x), exact=True)
    close(tc.poison(t(x), 1), jc.poison(jnp.asarray(x), 1), exact=True)
    close(tc.fetch_lane(t(x), 0, 3), jc.fetch_lane(jnp.asarray(x), 0, 3), exact=True)
    y = rng.standard_normal((2, P, 3)).astype(np.float32)
    close(tc.where_lane(1, t(y), t(-y), lane_axis=1),
          jc.where_lane(1, y, -y, lane_axis=1), exact=True)
    close(tc.fetch_lane(t(y), 2, 1, lane_axis=1),
          jc.fetch_lane(jnp.asarray(y), 2, 1, lane_axis=1), exact=True)
    assert tc.local_shape(t(x)) == jc.local_shape(x)
    np.testing.assert_array_equal(tc.axis_index().numpy(), np.asarray(jc.axis_index()))


# -- householder --------------------------------------------------------------


def test_householder_plain_functions_match_reference(rng):
    m, b, n = 12, 4, 6
    A = rng.standard_normal((m, b)).astype(np.float32)
    C = rng.standard_normal((m, n)).astype(np.float32)
    jwy, twy = J.householder_qr(jnp.asarray(A)), T.householder_qr(t(A))
    close_tuple(twy, jwy)
    close(T.q_dense(twy.Y, twy.T), J.q_dense(jwy.Y, jwy.T))
    close(T.apply_q(twy.Y, twy.T, t(C)), J.apply_q(jwy.Y, jwy.T, jnp.asarray(C)))
    close(T.apply_qt(twy.Y, twy.T, t(C)), J.apply_qt(jwy.Y, jwy.T, jnp.asarray(C)))
    R1 = np.triu(rng.standard_normal((b, b))).astype(np.float32) + 3 * np.eye(b, dtype=np.float32)
    R2 = np.triu(rng.standard_normal((b, b))).astype(np.float32)
    jsq, tsq = J.stacked_qr(jnp.asarray(R1), jnp.asarray(R2)), T.stacked_qr(t(R1), t(R2))
    close_tuple(tsq, jsq)
    Ct, Cb = C[:b], C[b:2 * b]
    for got, want in zip(T.stacked_apply_q(tsq, t(Ct), t(Cb)),
                         J.stacked_apply_q(jsq, jnp.asarray(Ct), jnp.asarray(Cb))):
        close(got, want)
    for got, want in zip(T.stacked_apply_qt(tsq, t(Ct), t(Cb)),
                         J.stacked_apply_qt(jsq, jnp.asarray(Ct), jnp.asarray(Cb))):
        close(got, want)


# -- tsqr ---------------------------------------------------------------------


@pytest.mark.parametrize("P,m_loc,b", [(4, 16, 4), (4, 3, 4), (8, 8, 4)])
def test_ft_tsqr_matches_reference(rng, P, m_loc, b):
    A = rng.standard_normal((P, m_loc, b)).astype(np.float32)
    got = T.ft_tsqr(t(A), T.SimComm(P))
    close_tuple(got, J.ft_tsqr(jnp.asarray(A), J.SimComm(P)))
    assert bool((got.R == got.R[:1]).all()), "R is not replicated bitwise"


def test_baseline_tsqr_and_q_match_reference(rng):
    P, m_loc, b = 4, 12, 4
    A = rng.standard_normal((P, m_loc, b)).astype(np.float32)
    tc, jc = T.SimComm(P), J.SimComm(P)
    close_tuple(T.baseline_tsqr(t(A), tc, broadcast_r=True),
                J.baseline_tsqr(jnp.asarray(A), jc, broadcast_r=True))
    Qt, Rt = T.dist_orthonormalize(t(A), tc)
    Qj, Rj = J.dist_orthonormalize(jnp.asarray(A), jc)
    close(Qt, Qj)
    close(Rt, Rj)
    close(T.ft_tsqr_q(T.ft_tsqr(t(A), tc, target=1), tc, target=1),
          J.ft_tsqr_q(J.ft_tsqr(jnp.asarray(A), jc, target=1), jc, target=1))


def test_local_tsqr_matches_reference(rng):
    A = rng.standard_normal((22, 4)).astype(np.float32)
    tf, tR = T.local_tsqr(t(A), 8)
    jf, jR = J.local_tsqr(jnp.asarray(A), 8)
    close_tuple(tf, jf)
    close(tR, jR)
    Qt, Rt = T.tsqr_orthonormalize(t(A), 8)
    Qj, _ = J.tsqr_orthonormalize(jnp.asarray(A), 8)
    close(Qt, Qj)


# -- trailing -----------------------------------------------------------------


@pytest.mark.parametrize("target", [3, 0])
def test_trailing_update_ft_matches_reference(rng, target):
    P, m_loc, b, n = 4, 16, 4, 10
    A = rng.standard_normal((P, m_loc, b)).astype(np.float32)
    C = rng.standard_normal((P, m_loc, n)).astype(np.float32)
    tc, jc = T.SimComm(P), J.SimComm(P)
    tfac = T.ft_tsqr(t(A), tc, target=target)
    jfac = J.ft_tsqr(jnp.asarray(A), jc, target=target)
    rs = np.array([0, 4, 8, 12], np.int32)
    act = np.array([False, True, True, True])
    got = T.trailing_update_ft(t(C), tfac, tc, target=target,
                               row_start=t(rs), active=t(act), dead_threshold=1)
    want = J.trailing_update_ft(jnp.asarray(C), jfac, jc, target=target,
                                row_start=jnp.asarray(rs),
                                active=jnp.asarray(act), dead_threshold=1)
    close(got[0], want[0])
    close_tuple(got[1], want[1])
    close(got[2], want[2])


def test_trailing_baseline_and_paper_semantics_match_reference(rng):
    P, m_loc, b, n = 4, 8, 4, 6
    A = rng.standard_normal((P, m_loc, b)).astype(np.float32)
    C = rng.standard_normal((P, m_loc, n)).astype(np.float32)
    tc, jc = T.SimComm(P), J.SimComm(P)
    close(T.trailing_update_baseline(t(C), T.baseline_tsqr(t(A), tc), tc),
          J.trailing_update_baseline(jnp.asarray(C), J.baseline_tsqr(jnp.asarray(A), jc), jc))
    got = T.trailing_update_ft(t(C), T.ft_tsqr(t(A), tc, target=0), tc,
                               target=0, paper_semantics=True)
    want = J.trailing_update_ft(jnp.asarray(C), J.ft_tsqr(jnp.asarray(A), jc, target=0),
                                jc, target=0, paper_semantics=True)
    close(got[0], want[0])


# -- caqr ---------------------------------------------------------------------

GEOMS = {"aligned": (4, 32, 64, 8), "ragged": (4, 6, 10, 4), "wide": (4, 4, 40, 4)}


@pytest.mark.parametrize("use_scan", [False, True], ids=["windowed", "full-width"])
@pytest.mark.parametrize("geom", list(GEOMS), ids=list(GEOMS))
def test_caqr_factorize_matches_reference(rng, geom, use_scan):
    P, m_loc, n, b = GEOMS[geom]
    A = rng.standard_normal((P, m_loc, n)).astype(np.float32)
    got = T.caqr_factorize(t(A), T.SimComm(P), b, collect_bundles=True, use_scan=use_scan)
    want = J.caqr_factorize(jnp.asarray(A), J.SimComm(P), b, collect_bundles=True,
                            use_scan=use_scan)
    close(got.R, want.R)
    close_tuple(got.factors, want.factors)
    close_tuple(got.bundles, want.bundles)
    assert bool((got.R == got.R[:1]).all())
    assert T.sweep_geometry(P, m_loc, n, b) == J.sweep_geometry(P, m_loc, n, b)


@pytest.mark.parametrize("geom", list(GEOMS), ids=list(GEOMS))
def test_windowed_equals_full_width_bitwise(rng, geom):
    P, m_loc, n, b = GEOMS[geom]
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32))
    w = T.caqr_factorize(A, T.SimComm(P), b, collect_bundles=True, use_scan=False)
    f = T.caqr_factorize(A, T.SimComm(P), b, collect_bundles=True, use_scan=True)
    assert torch.equal(w.R, f.R)
    for a, c in zip(w.factors, f.factors):
        assert torch.equal(a, c)


@pytest.mark.parametrize("geom", list(GEOMS), ids=list(GEOMS))
def test_caqr_apply_qt_matches_reference(rng, geom):
    P, m_loc, n, b = GEOMS[geom]
    A = rng.standard_normal((P, m_loc, n)).astype(np.float32)
    B = rng.standard_normal((P, m_loc, 3)).astype(np.float32)
    res = T.caqr_factorize(t(A), T.SimComm(P), b, use_scan=False)
    jres = J.caqr_factorize(jnp.asarray(A), J.SimComm(P), b, use_scan=False)
    close(T.caqr_apply_qt(t(B), res.factors, T.SimComm(P)),
          J.caqr_apply_qt(jnp.asarray(B), jres.factors, J.SimComm(P)))


@pytest.mark.parametrize("geom", list(GEOMS), ids=list(GEOMS))
def test_caqr_lstsq_matches_reference(rng, geom):
    P, m_loc, n, b = GEOMS[geom]
    A = rng.standard_normal((P, m_loc, n)).astype(np.float32)
    rhs = rng.standard_normal((P, m_loc, 2)).astype(np.float32)
    got = tlstsq.caqr_lstsq(t(A), t(rhs), T.SimComm(P), b)
    want = jlstsq.caqr_lstsq(jnp.asarray(A), jnp.asarray(rhs), J.SimComm(P), b)
    close(got, want)
    if geom == "wide":  # the basic solution solves A x = b exactly
        Af = A.reshape(-1, n).astype(np.float64)
        r = Af @ got.numpy() - rhs.reshape(-1, 2)
        assert np.abs(r).max() < 1e-3


def test_geometry_helpers_match_reference():
    for P, m_loc, n, b in [(4, 8, 16, 4), (4, 6, 10, 4), (4, 3, 21, 4), (2, 8, 3, 8),
                           (8, 4096, 4096, 128), (8, 4000, 4000, 128)]:
        g = T.sweep_geometry(P, m_loc, n, b)
        assert g == J.sweep_geometry(P, m_loc, n, b)
        assert (g.aligned, g.levels) == (J.sweep_geometry(P, m_loc, n, b).aligned,
                                         J.sweep_geometry(P, m_loc, n, b).levels)
        m_pad = g.m_loc_pad
        for k in range(g.n_panels):
            tg = T.panel_geometry(T.SimComm(P), k, b, m_pad)
            jg = J.panel_geometry(J.SimComm(P), k, b, m_pad)
            assert tg[:2] == jg[:2]
            np.testing.assert_array_equal(tg[2].numpy(), np.asarray(jg[2]))
            np.testing.assert_array_equal(tg[3].numpy(), np.asarray(jg[3]))
            for lane in range(P):
                assert T.lane_geometry(k, b, m_pad, lane) == J.lane_geometry(k, b, m_pad, lane)


def test_block_row_layout_matches_reference(rng):
    A = rng.standard_normal((13, 5)).astype(np.float32)
    close(T.block_row_layout(A, 4, n=7, device="cpu"),
          J.block_row_layout(jnp.asarray(A), 4, n=7), exact=True)
