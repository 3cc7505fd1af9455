"""The port's coded checksum lanes (``repro_torch.ft.coding``) against the
JAX package's ``repro.ft.coding``, and the coding contracts inside the
port.

Everything here is integer math on identical input bytes, so the GF(2^8)
tables, the generators, their inverses and the parity bytes must equal
the reference's exactly. The bitwise contracts are the port's own:
``MDSScheme(f=1)`` == ``XORPairScheme`` (ledgers included), any dead set
of size at most ``f`` decodes to the failure-free state, and ``f + 1``
deaths raise. Floats cross between the packages only through the wire
format and are compared within the f32 pair of
``repro.kernels.ref.tolerances``.
"""
import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import repro.ft as jft
from repro.core import SimComm as JSimComm
from repro.ft import coding as jcoding
from repro.ft.online import detect as jdetect
from repro.ft.online import state as jstate
from repro.kernels.ref import tolerances
from repro_torch.core import SimComm, caqr_factorize, sweep_geometry
from repro_torch.ft import (
    FailureSchedule,
    MDSScheme,
    ScriptedKiller,
    SweepOrchestrator,
    UnrecoverableFailure,
    XORPairScheme,
    ft_caqr_sweep,
    ft_caqr_sweep_online,
    iter_sweep_points,
    obliterate_state,
    prev_sweep_point,
    sweep_point,
)
from repro_torch.ft import coding as tcoding
from repro_torch.ft.online import state as tstate

RTOL, ATOL = tolerances(np.float32)

# the reference's P = 8 kill-matrix geometry: 2 panels, 3 tree levels
P8, M8, N8, B8 = 8, 4, 8, 4
G8 = sweep_geometry(P8, M8, N8, B8)
POINTS8 = list(iter_sweep_points(G8.n_panels, G8.levels))


def _matrix(P, m_loc, n, seed=7):
    return np.random.default_rng(seed).standard_normal((P, m_loc, n)).astype(
        np.float32)


def _flat(res):
    return (res.R, *res.factors, *res.bundles)


def _assert_bitwise(got, want, tag=""):
    g, w = _flat(got), _flat(want)
    assert len(g) == len(w)
    for x, y in zip(g, w):
        assert x.dtype == y.dtype and torch.equal(x, y), tag


def _lockstep(P, m_loc, n, b, steps, seed=7):
    """The same state in both packages after ``steps`` points: the JAX
    state, and the port's loaded from its wire format (identical bytes)."""
    jc = JSimComm(P)
    js = jstate.run_steps(
        jc, jstate.initial_sweep_state(jc, jnp.asarray(_matrix(P, m_loc, n,
                                                               seed)), b),
        steps)
    ts = tstate.sweep_state_from_host(jstate.sweep_state_to_host(js),
                                      device="cpu")
    return js, ts


# -- the GF(2^8) algebra --------------------------------------------------------


def test_gf_tables_equal_reference():
    assert np.array_equal(tcoding.GF_EXP, jcoding.GF_EXP)
    assert np.array_equal(tcoding.GF_LOG, jcoding.GF_LOG)
    assert np.array_equal(tcoding._MUL, jcoding._MUL)
    for a in range(256):
        for b in (0, 1, 2, 29, 142, 255):
            assert tcoding.gf_mul(a, b) == jcoding.gf_mul(a, b)
        if a:
            assert tcoding.gf_inv(a) == jcoding.gf_inv(a)
    with pytest.raises(ZeroDivisionError):
        tcoding.gf_inv(0)


@pytest.mark.parametrize("P", [2, 4, 8, 16, 255])
def test_generators_equal_reference(P):
    for f in range(1, 9):
        assert np.array_equal(tcoding.generator(f, P),
                              jcoding.generator(f, P))
    with pytest.raises(ValueError):
        tcoding.generator(2, 256)


@pytest.mark.parametrize("f", [1, 2, 3])
def test_inverse_matrices_equal_reference(f):
    """Every f-column Vandermonde submatrix at P = 8 inverts to the
    reference's bytes, and the product is the identity over GF(2^8)."""
    G = tcoding.generator(f, P8)
    for cols in itertools.combinations(range(P8), f):
        M = G[:, list(cols)]
        inv = tcoding.gf_inv_matrix(M)
        assert np.array_equal(inv, jcoding.gf_inv_matrix(M)), cols
        prod = np.zeros((f, f), np.uint8)
        for i, j in itertools.product(range(f), range(f)):
            for k in range(f):
                prod[i, j] ^= tcoding.gf_mul(int(M[i, k]), int(inv[k, j]))
        assert np.array_equal(prod, np.eye(f, dtype=np.uint8)), cols


def test_pairing_helpers_are_reexported():
    for P in (2, 4, 8):
        assert tcoding.pairing_table(P) == jcoding.pairing_table(P)
    assert tcoding.xor_buddy(5, 1) == jcoding.xor_buddy(5, 1) == 7


# -- protected leaves and parity bytes ------------------------------------------


@pytest.mark.parametrize("steps", [1, 3, 7, 9, 14])
def test_protected_leaves_follow_jax_leaf_order(steps):
    """``_protected`` gives the reference's (leaf index, lane axis) list:
    the port's leaf order is JAX's ``tree_leaves`` order over SweepState."""
    js, ts = _lockstep(P8, M8, N8, B8, steps)
    assert tcoding._protected(ts) == jcoding._protected(js)
    assert len(tcoding._protected(ts)) > 0


@pytest.mark.parametrize("f", [1, 2, 3])
@pytest.mark.parametrize("steps", [1, 5, 9, 14])
def test_parity_bytes_equal_reference(f, steps):
    """MDSScheme.refresh on identical state bytes: the parity tuple equals
    JAX's byte for byte, shape for shape."""
    js, ts = _lockstep(P8, M8, N8, B8, steps)
    want = jcoding.MDSScheme(f=f).refresh(JSimComm(P8), js).code
    got = MDSScheme(f=f).refresh(SimComm(P8), ts).code
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == torch.uint8 and tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy(), w)


def test_xor_reduce_is_the_f1_parity():
    """Row 0 of the generator is all-ones: the f=1 parity of a leaf is the
    lane-axis XOR of its bytes (``SimComm.xor_reduce``)."""
    _, ts = _lockstep(P8, M8, N8, B8, 5)
    code = MDSScheme(f=1).refresh(SimComm(P8), ts).code
    leaves = tstate.flat_arrays(ts)
    axes = tstate.flat_arrays(tstate.state_lane_axes(ts))
    for parity, (key, ax) in zip(code, tcoding._protected_leaves(ts)):
        x = torch.movedim(leaves[key], ax, 0).contiguous()
        xb = x.view(torch.uint8).reshape(*x.shape, 4)
        assert torch.equal(SimComm(P8).xor_reduce(xb), parity[0])
        assert axes[key] == ax
    assert torch.equal(SimComm(P8).lane_slice(leaves["A"], 3), leaves["A"][3])


# -- decode: any f deaths, bitwise ----------------------------------------------


@pytest.mark.parametrize("P,f", [(4, 1), (4, 2), (4, 3), (8, 1), (8, 2),
                                 (8, 3)])
def test_every_dead_set_within_f_decodes_bitwise(P, f):
    """Encode a mid-sweep state, kill every dead set of size 1..f with the
    real death mask, decode: every leaf equals the live state bit for bit,
    and the ledger reads every survivor and the first t parity slots."""
    comm = SimComm(P)
    scheme = MDSScheme(f=f)
    s = tstate.initial_sweep_state(comm, torch.from_numpy(_matrix(P, 4, 8)), 4)
    points = tstate.panel_points(s.geom) * s.geom.n_panels
    for steps in (2, points - 2):
        live = scheme.refresh(comm, tstate.run_steps(comm, s, steps))
        want = tstate.flat_arrays(live)
        for t in range(1, f + 1):
            for dead in itertools.combinations(range(P), t):
                struck = live
                for lane in dead:
                    struck = obliterate_state(comm, struck, lane)
                got, reads = scheme.decode_lanes(comm, struck, list(dead),
                                                 set(dead))
                got = tstate.flat_arrays(got)
                assert got.keys() == want.keys()
                assert all(torch.equal(got[k], want[k]) for k in want), dead
                assert reads == {
                    **{f"coded.parity{j}": P + j for j in range(t)},
                    **{f"coded.survivor{i}": i for i in range(P)
                       if i not in dead}}


@pytest.fixture(scope="module")
def ref8():
    A = torch.from_numpy(_matrix(P8, M8, N8))
    return A, caqr_factorize(A, SimComm(P8), B8, collect_bundles=True,
                             use_scan=False)


@pytest.mark.parametrize("pt", [POINTS8[0], POINTS8[2], POINTS8[5],
                                POINTS8[8], POINTS8[13]],
                         ids=lambda p: f"{p[0]}-{p[1]}{p[2]}")
def test_pair_kill_matrix_end_to_end_p8(ref8, pt):
    """All 28 lane pairs (every former buddy pair among them) killed at
    once at this point of the online sweep under MDSScheme(f=2): the
    finished factorization is bit-identical to the failure-free one."""
    A, ref = ref8
    for pair in itertools.combinations(range(P8), 2):
        got = ft_caqr_sweep_online(A, SimComm(P8), B8, scheme=MDSScheme(f=2),
                                   fault_hooks=[ScriptedKiller({pt: pair})])
        _assert_bitwise(got, ref, f"{pt} {pair}")
        assert [(e.point, e.lane) for e in got.events] == \
            [(pt, pair[0]), (pt, pair[1])]
        assert all(e.reads["coded.parity1"] == P8 + 1 for e in got.events)


def test_triple_kill_under_f3_matches_reference_ledger(ref8):
    A, ref = ref8
    pt, trip = sweep_point(1, "trailing", 0), [2, 3, 7]
    got = ft_caqr_sweep(A, SimComm(P8), B8, scheme=MDSScheme(f=3),
                        schedule=FailureSchedule(events={pt: trip}))
    _assert_bitwise(got, ref, "f3")
    want = jft.ft_caqr_sweep(
        jnp.asarray(A.numpy()), JSimComm(P8), B8, scheme=jft.MDSScheme(f=3),
        schedule=jft.FailureSchedule(events={pt: trip}))
    assert [(e.point, e.lane, e.reads) for e in got.events] == \
        [(e.point, e.lane, e.reads) for e in want.events]
    w = np.asarray(want.R)
    np.testing.assert_allclose(got.R.numpy(), w, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(w).max()))


def test_f_plus_one_deaths_raise(ref8):
    A, _ = ref8
    pt = sweep_point(1, "trailing", 0)
    for scheme, kill, tag in ((MDSScheme(f=2), [0, 1, 2], "f=2"),
                              (MDSScheme(f=1), [2, 3], "f=1")):
        with pytest.raises(UnrecoverableFailure, match=tag):
            ft_caqr_sweep_online(A, SimComm(P8), B8, scheme=scheme,
                                 fault_hooks=[ScriptedKiller({pt: kill})])
    with pytest.raises(UnrecoverableFailure):
        ft_caqr_sweep(A, SimComm(P8), B8,
                      schedule=FailureSchedule(events={pt: [2, 3]}))


def test_t_exceeding_f_falls_back_to_xor(ref8):
    A, ref = ref8
    pt = sweep_point(0, "trailing", 0)
    got = ft_caqr_sweep_online(A, SimComm(P8), B8, scheme=MDSScheme(f=2),
                               fault_hooks=[ScriptedKiller({pt: [0, 2, 4]})])
    _assert_bitwise(got, ref, "xor fallback")
    assert all(not k.startswith("coded.") for e in got.events for k in e.reads)


def test_scheme_validation():
    for f in (0, 9):
        with pytest.raises(ValueError):
            MDSScheme(f=f)
    assert MDSScheme(f=2).name == "mds" and MDSScheme(f=2).joint
    assert XORPairScheme().f == 1 and not XORPairScheme().joint
    with pytest.raises(NotImplementedError):
        tcoding._encode_axis(None, None, None)


# -- MDSScheme(f=1) == XOR inside the port ---------------------------------------


@pytest.mark.parametrize("shape", [
    ("aligned", 8, 16, 4), ("ragged", 6, 10, 4), ("wide", 4, 24, 4),
], ids=lambda s: s[0])
def test_mds_f1_bitwise_equals_xor(shape):
    """At f=1 every single death takes the XOR REBUILD: same bits and the
    same single-source ledger as XORPairScheme, scheduled and online."""
    _, m_loc, n, b = shape
    P, comm = 4, SimComm(4)
    A = torch.from_numpy(_matrix(P, m_loc, n, seed=5))
    n_panels = sweep_geometry(P, m_loc, n, b).n_panels
    pt = sweep_point(min(1, n_panels - 1), "trailing", 0)
    for tag, run in (
            ("scheduled", lambda s: ft_caqr_sweep(
                A, comm, b, schedule=FailureSchedule(events={pt: [2]}),
                scheme=s)),
            ("online", lambda s: ft_caqr_sweep_online(
                A, comm, b, scheme=s,
                fault_hooks=[ScriptedKiller({pt: [2]})]))):
        x, m = run(XORPairScheme()), run(MDSScheme(f=1))
        _assert_bitwise(m, x, tag)
        assert [(e.point, e.lane, e.reads) for e in x.events] == \
            [(e.point, e.lane, e.reads) for e in m.events], tag
        assert all(not k.startswith("coded.")
                   for e in m.events for k in e.reads), tag


def test_scheduled_equals_online_mds_buddy_pair():
    """The buddy-pair kill that XOR cannot recover: under MDSScheme(f=2)
    scheduled == online == failure-free, bitwise, with equal ledgers."""
    P, m_loc, n, b = 4, 6, 10, 4
    A = torch.from_numpy(_matrix(P, m_loc, n, seed=3))
    comm = SimComm(P)
    pt = sweep_point(1, "trailing", 0)
    free = ft_caqr_sweep(A, comm, b)
    sched = ft_caqr_sweep(A, comm, b, scheme=MDSScheme(f=2),
                          schedule=FailureSchedule(events={pt: [2, 3]}))
    onl = ft_caqr_sweep_online(A, comm, b, scheme=MDSScheme(f=2),
                               fault_hooks=[ScriptedKiller({pt: [2, 3]})])
    _assert_bitwise(sched, free, "scheduled")
    _assert_bitwise(onl, free, "online")
    assert [(e.point, e.lane, e.reads) for e in sched.events] == \
        [(e.point, e.lane, e.reads) for e in onl.events]


# -- a JAX state with MDS parity resumes in the port -----------------------------


@pytest.mark.parametrize("steps", [5, 8])
def test_jax_state_with_parity_resumes_in_port(steps):
    """A JAX state refreshed under MDSScheme(f=2) crosses in wire format
    v2: its parity bytes arrive unchanged, the port re-encodes the same
    bytes, and a buddy-pair death at the resume boundary is decoded from
    the persisted parity: R within tolerance of the JAX resume, ledger
    exactly JAX's."""
    P, m_loc, n, b = 4, 6, 10, 4
    jc = JSimComm(P)
    A = jnp.asarray(_matrix(P, m_loc, n, seed=3))
    js = jstate.run_steps(jc, jstate.initial_sweep_state(jc, A, b), steps)
    js = jcoding.MDSScheme(f=2).refresh(jc, js)
    ts = tstate.sweep_state_from_host(jstate.sweep_state_to_host(js),
                                      device="cpu")
    assert len(ts.code) == len(js.code)
    for g, w in zip(ts.code, js.code):
        assert g.dtype == torch.uint8 and np.array_equal(g.numpy(),
                                                         np.asarray(w))
    again = MDSScheme(f=2).refresh(SimComm(P), ts.replace(code=None)).code
    assert all(torch.equal(g, w) for g, w in zip(again, ts.code))

    point = prev_sweep_point(ts.cursor, ts.geom.n_panels, ts.geom.levels)
    got = SweepOrchestrator.from_state(
        ts, SimComm(P), scheme=MDSScheme(f=2),
        fault_hooks=[ScriptedKiller({point: [2, 3]})]).run()
    want = jft.SweepOrchestrator.from_state(
        js, jc, scheme=jft.MDSScheme(f=2),
        fault_hooks=[jdetect.ScriptedKiller({point: [2, 3]})]).run()
    assert [(e.point, e.lane, e.reads) for e in got.events] == \
        [(e.point, e.lane, e.reads) for e in want.events]
    assert [e.lane for e in got.events] == [2, 3]
    w = np.asarray(want.R)
    np.testing.assert_allclose(got.R.numpy(), w, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(w).max()))
    # inside the port the decode is exact: the same resume without a death
    clean = SweepOrchestrator.from_state(ts, SimComm(P),
                                         scheme=MDSScheme(f=2)).run()
    _assert_bitwise(got, clean, "decode at the resume boundary")
