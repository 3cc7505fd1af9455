"""Single-source recovery in the port (``repro_torch.core.recovery``).

Inside the port the paper's claim is bitwise: a lane killed after any
level and rebuilt from ONE buddy's bundle finishes bit-identical to the
failure-free run, because recovery replays the pair combine through the
same kernel (``_combine``) the level ran. Against the JAX package the
comparison is within tolerance.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
from repro.core import recovery as jrec
import repro_torch.core as T
from repro_torch.core import recovery as rec

TOL = 3e-4


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def setup(rng, P=8, m_loc=32, b=8, n=24):
    A = rng.standard_normal((P, m_loc, b)).astype(np.float32)
    C = rng.standard_normal((P, m_loc, n)).astype(np.float32)
    comm = T.SimComm(P)
    return A, C, comm, T.ft_tsqr(t(A), comm)


@pytest.mark.parametrize("level", [0, 1, 2])
@pytest.mark.parametrize("failed", [0, 3, 5, 7])
def test_kill_and_recover_is_bitwise_clean(rng, level, failed):
    _, C, comm, fac = setup(rng)
    clean = rec.run_ft_trailing(t(C), fac, comm)
    faulty = rec.run_ft_trailing(t(C), fac, comm, fail_at_level=level,
                                 failed_lane=failed, A_stacked=t(C))
    assert torch.equal(clean, faulty)


def test_kill_on_a_strided_window_is_bitwise_clean(rng):
    """The chip run's form: panel and trailing columns are views of one A."""
    P, m_loc, b = 4, 16, 4
    A = t(rng.standard_normal((P, m_loc, 3 * b)).astype(np.float32))
    comm = T.SimComm(P)
    fac = T.ft_tsqr(A[..., :b], comm)
    C = A[..., b:]
    clean = rec.run_ft_trailing(C, fac, comm)
    faulty = rec.run_ft_trailing(C, fac, comm, fail_at_level=1, failed_lane=3,
                                 A_stacked=C)
    assert torch.equal(clean, faulty)


def test_run_ft_trailing_matches_reference(rng):
    A, C, comm, fac = setup(rng)
    got = rec.run_ft_trailing(t(C), fac, comm, fail_at_level=1, failed_lane=3,
                              A_stacked=t(C))
    jc = J.SimComm(8)
    want = jrec.run_ft_trailing(jnp.asarray(C), J.ft_tsqr(jnp.asarray(A), jc), jc)
    w = np.asarray(want, np.float64)
    np.testing.assert_allclose(got.numpy(), w, rtol=TOL,
                               atol=TOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("failed", [2, 6])
def test_combine_replay_equals_the_original_level(rng, failed):
    """recover_cprime reads one source lane's bundle and replays the pair
    combine: it equals the failed lane's post-level C' bitwise, even with
    every other lane's bundle poisoned."""
    _, C, comm, fac = setup(rng)
    state = rec.trailing_begin(t(C), fac, comm)
    for level in range(3):
        state, bundle = rec.trailing_level(state, fac, comm)
        source = failed ^ (1 << level)
        poisoned = bundle
        for lane in range(8):
            if lane != source:
                poisoned = rec.LevelBundle(*(
                    comm.poison(x, lane) if x.is_floating_point() else x
                    for x in poisoned))
        got = rec.recover_cprime(poisoned, failed, source)
        assert torch.equal(got, state.C_prime[failed])


def test_rebuild_primitives_replay_the_sweep(rng):
    """recompute_leaf and rebuild_block_row_through_panel rebuild a lane's
    sweep state from its own rows plus one buddy's final C'."""
    P, m_loc, n, b = 4, 8, 16, 4
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32))
    comm = T.SimComm(P)
    res = T.caqr_factorize(A, comm, b, use_scan=False, collect_bundles=True)
    lane, k = 1, 0
    col0, t_lane, rs, active = T.lane_geometry(k, b, m_loc, lane)
    Y, Tf, R = rec.recompute_leaf(A[lane], col0, b, rs, active)
    assert torch.equal(Y, res.factors.leaf_Y[k, lane])
    assert torch.equal(Tf, res.factors.leaf_T[k, lane])
    z = rec.recompute_leaf(A[lane], col0, b, rs, False)
    assert all(bool((x == 0).all()) for x in z)
    # the lane's final C' after the last level, from its buddy's bundle
    bun = res.bundles
    L = bun.W.shape[1]
    last = L - 1
    src = rec.xor_buddy(lane, last)
    Cp = rec.rebuild_cprime_after_level(
        bun.C_buddy[k, last, src], bun.C_self[k, last, src],
        bun.Y2[k, last, src], bun.T[k, last, src],
        failed_was_top=bool(bun.self_was_top[k, last, lane]),
        pair_live=bool(lane >= t_lane and src >= t_lane))
    rows = rec.rebuild_block_row_through_panel(A[lane], Y, Tf, Cp, col0, rs, active)
    want = T.trailing_update_ft(
        A, T.DistTSQRFactors(res.factors.leaf_Y[k], res.factors.leaf_T[k],
                             res.factors.level_Y2[k], res.factors.level_T[k],
                             res.factors.leaf_T[k]),
        comm, target=t_lane, row_start=res.factors.row_start[k],
        active=res.factors.active[k], dead_threshold=t_lane)[0]
    assert torch.equal(rows, want[lane])


def test_pairing_and_tsqr_recovery_match_reference(rng):
    for P in (2, 4, 8, 16):
        assert rec.pairing_table(P) == jrec.pairing_table(P)
        for lane in range(P):
            for level in range(P.bit_length() - 1):
                assert rec.xor_buddy(lane, level) == jrec.xor_buddy(lane, level)
    _, _, _, fac = setup(rng)
    assert torch.equal(rec.tsqr_recover_r(fac, failed=5, source=5 ^ 4), fac.R[5])
