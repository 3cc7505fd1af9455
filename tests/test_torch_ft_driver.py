"""The port's FT sweep driver (``repro_torch.ft.driver``): the paper's
headline claim inside the port, and its ledgers against the JAX package.

A lane dies at any panel, after the leaf or any TSQR or trailing-combine
level, is respawned from its re-read initial slice plus single-source
buddy fetches, and the finished factorization (R, per-panel factors AND
recovery bundles) is bit-identical to the port's failure-free sweep.
Against the JAX package: the event ledgers ``(point, lane, reads)`` are
exactly equal, and R is within the f32 tolerance.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.ft as jft
from repro.core import SimComm as JSimComm
from repro.kernels.ref import tolerances
from repro_torch.core import SimComm, caqr_factorize, sweep_geometry
from repro_torch.ft import (
    FailureSchedule,
    Semantics,
    UnrecoverableFailure,
    ft_caqr_sweep,
    iter_sweep_points,
    sweep_point,
)

RTOL, ATOL = tolerances(np.float32)

# ragged: unaligned lane heights and a ragged last panel (3 padded panels)
RP, RM_LOC, RN, RB = 4, 6, 10, 4
RGEOM = sweep_geometry(RP, RM_LOC, RN, RB)


def _matrix(P, m_loc, n, seed=3):
    return np.random.default_rng(seed).standard_normal((P, m_loc, n)).astype(
        np.float32)


def _leaves(res):
    return (res.R, *res.factors, *res.bundles)


def _assert_bit_identical(got, ref):
    g, r = _leaves(got), _leaves(ref)
    assert len(g) == len(r)
    for x, y in zip(g, r):
        assert x.dtype == y.dtype and torch.equal(x, y), \
            "driver output differs from the failure-free sweep"


@pytest.fixture(scope="module")
def ragged():
    A = torch.from_numpy(_matrix(RP, RM_LOC, RN))
    ref = caqr_factorize(A, SimComm(RP), RB, collect_bundles=True,
                         use_scan=False)
    return A, ref


def test_failure_free_driver_matches_windowed_sweep(ragged):
    A, ref = ragged
    got = ft_caqr_sweep(A, SimComm(RP), RB)
    _assert_bit_identical(got, ref)
    assert got.events == []
    assert tuple(got.R.shape) == (RP, RGEOM.k, RN)


@pytest.mark.parametrize("lane", range(RP))
@pytest.mark.parametrize("point", list(iter_sweep_points(RGEOM.n_panels,
                                                         RGEOM.levels)),
                         ids=lambda p: f"p{p[0]}-{p[1]}{p[2]}")
def test_ragged_kill_matrix_is_bitwise(ragged, point, lane):
    """Every lane x every point of the ragged sweep: kill, rebuild from
    single-source buddy fetches, finish; bit-identical to failure-free."""
    A, ref = ragged
    got = ft_caqr_sweep(A, SimComm(RP), RB,
                        schedule=FailureSchedule(events={point: [lane]}))
    _assert_bit_identical(got, ref)
    (event,) = got.events
    assert event.point == point and event.lane == lane
    assert all(src != lane and 0 <= src < RP for src in event.reads.values())
    if point[1] != "leaf" or point[0] > 0:
        assert event.reads, f"no fetches recorded for {point}"


SPOTS = [
    (sweep_point(0, "leaf"), 0),
    (sweep_point(0, "trailing", 1), 1),
    (sweep_point(1, "tsqr", 0), 3),
    (sweep_point(2, "trailing", 0), 1),
    (sweep_point(2, "tsqr", 1), 0),
]


@pytest.mark.parametrize("point,lane", SPOTS,
                         ids=[f"p{p[0]}-{p[1]}{p[2]}-lane{l}" for p, l in SPOTS])
def test_ledgers_and_R_match_reference(point, lane):
    A = _matrix(RP, RM_LOC, RN, seed=9)
    got = ft_caqr_sweep(torch.from_numpy(A), SimComm(RP), RB,
                        schedule=FailureSchedule(events={point: [lane]}))
    want = jft.ft_caqr_sweep(jnp.asarray(A), JSimComm(RP), RB,
                             schedule=jft.FailureSchedule(events={point: [lane]}))
    assert [(e.point, e.lane, e.reads) for e in got.events] == \
        [(e.point, e.lane, e.reads) for e in want.events]
    w = np.asarray(want.R)
    np.testing.assert_allclose(got.R.numpy(), w, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(w).max()))


def test_buddy_pair_death_is_unrecoverable_in_both():
    A = _matrix(RP, RM_LOC, RN)
    point = sweep_point(1, "trailing", 0)
    with pytest.raises(UnrecoverableFailure):
        ft_caqr_sweep(torch.from_numpy(A), SimComm(RP), RB,
                      schedule=FailureSchedule(events={point: [2, 3]}))
    with pytest.raises(jft.UnrecoverableFailure):
        jft.ft_caqr_sweep(jnp.asarray(A), JSimComm(RP), RB,
                          schedule=jft.FailureSchedule(events={point: [2, 3]}))


@pytest.mark.parametrize("events,expect", [
    ({sweep_point(0, "trailing", 1): [2], sweep_point(2, "tsqr", 0): [1]},
     [((0, "trailing", 1), 2), ((2, "tsqr", 0), 1)]),
    ({sweep_point(0, "trailing", 0): [1], sweep_point(2, "trailing", 1): [1]},
     [((0, "trailing", 0), 1), ((2, "trailing", 1), 1)]),
    ({sweep_point(1, "trailing", 0): [0, 3]},
     [((1, "trailing", 0), 0), ((1, "trailing", 0), 3)]),
], ids=["two-panels", "same-lane-twice", "non-buddy-pair"])
def test_several_deaths_recover_bitwise(ragged, events, expect):
    A, ref = ragged
    got = ft_caqr_sweep(A, SimComm(RP), RB,
                        schedule=FailureSchedule(events=events))
    _assert_bit_identical(got, ref)
    assert [(e.point, e.lane) for e in got.events] == expect


@pytest.mark.parametrize("P,m_loc,n,b,point,lane", [
    (4, 8, 16, 4, sweep_point(3, "trailing", 1), 2),   # aligned, square
    (4, 4, 24, 4, sweep_point(2, "trailing", 1), 2),   # wide: R2 columns
    (8, 8, 32, 4, sweep_point(7, "trailing", 1), 5),   # P=8, root at lane 3
    (8, 8, 32, 4, sweep_point(3, "tsqr", 2), 0),
])
def test_other_geometries_kill_is_bitwise(P, m_loc, n, b, point, lane):
    A = torch.from_numpy(_matrix(P, m_loc, n, seed=4))
    comm = SimComm(P)
    ref = caqr_factorize(A, comm, b, collect_bundles=True, use_scan=False)
    got = ft_caqr_sweep(A, comm, b,
                        schedule=FailureSchedule(events={point: [lane]}))
    _assert_bit_identical(got, ref)
    assert [(e.point, e.lane) for e in got.events] == [(point, lane)]


def test_recovery_sources_are_tree_buddies():
    """lane^1 for the TSQR ladder, lane^(1<<s) for level-s trailing state,
    the last-level buddy for a completed panel's final C'."""
    P, m_loc, n, b = 4, 8, 16, 4
    A = torch.from_numpy(_matrix(P, m_loc, n, seed=0))
    lane, lvl = 2, 1
    got = ft_caqr_sweep(A, SimComm(P), b, schedule=FailureSchedule(
        events={sweep_point(1, "trailing", lvl): [lane]}))
    (event,) = got.events
    assert event.reads["tsqr.ladder"] == lane ^ 1
    assert event.reads[f"trailing.cprime@level{lvl}"] == lane ^ (1 << lvl)
    for s in range(lvl + 1):
        assert event.reads[f"trailing.bundle@level{s}"] == lane ^ (1 << s)
    assert event.reads["panel0.cprime_final"] == lane ^ 2
    assert event.sources == sorted(set(event.reads.values()))


@pytest.mark.parametrize("semantics", [Semantics.SHRINK, Semantics.BLANK])
def test_elastic_semantics_are_not_ported(semantics):
    A = torch.from_numpy(_matrix(RP, RM_LOC, RN))
    with pytest.raises(NotImplementedError):
        ft_caqr_sweep(A, SimComm(RP), RB, semantics=semantics)
    assert ft_caqr_sweep(A, SimComm(RP), RB,
                         semantics=Semantics.REBUILD).events == []
