"""The port's CUDA kernels K1-K6 against their plain PyTorch versions on
the card, and the port's bitwise contracts there (fused == stepped, kill
== failure-free, online == scheduled, async == sync, MDS decode ==
failure-free, SHRINK scheduled == online). Needs an NVIDIA GPU with nvcc; every test skips without
one.

Imports neither JAX nor the JAX package, so it also runs on a machine
with the card and no JAX: ``python -m pytest -q tests/test_torch_cuda.py``.
Tolerance: the f32 pair of ``repro_torch.kernels.ref.tolerances``, as
``atol = 3e-4 * max(1, max|plain|)``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SimComm, caqr_factorize, ft_tsqr, recovery
from repro_torch.ft import (
    FailureSchedule,
    MDSScheme,
    ScriptedKiller,
    Semantics,
    SweepOrchestrator,
    ft_caqr_sweep,
    ft_caqr_sweep_online,
    sweep_point,
)
from repro_torch.ft.online import state as tstate
from repro_torch.kernels import backend, ops
from repro_torch.kernels import panel_qr as tpanel
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stacked_qr as tstacked
from repro_torch.kernels import wy_apply as twy

RTOL, ATOL = tref.tolerances(torch.float32)


def close(got, want):
    """Each kernel output (CUDA) within tolerance of the plain version's."""
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        w = w.cpu().double().numpy()
        np.testing.assert_allclose(
            g.cpu().double().numpy(), w, rtol=RTOL,
            atol=ATOL * max(1.0, np.abs(w).max(initial=0)))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def qr_factor(rng, b):
    """A well-conditioned upper-triangular b x b R factor."""
    return np.linalg.qr(rng.standard_normal((2 * b, b)))[1].astype(np.float32)


# Edge inputs of K3, the butterfly's stacked QR (``stacked_edge_pair``).
STACKED_EDGES = ("zero_bot", "zero_top", "both_zero", "garbage_lower",
                 "rank_deficient", "tiny_column")


def stacked_edge_pair(rng, case, b):
    """(R_top, R_bot), two (b, b) f32 triangles for one of STACKED_EDGES: a
    zero triangle, or both; large garbage in the strict lower triangles,
    which the QR must not read; two columns zero in both, so the stack
    loses rank and those columns are exactly degenerate (tau = 0); a column
    scaled by 1e-32 in both, whose squares underflow to 0 (degenerate, with
    v = e_j + x_below)."""
    R1, R2 = qr_factor(rng, b), qr_factor(rng, b)
    if case == "zero_bot":
        R2[:] = 0
    elif case == "zero_top":
        R1[:] = 0
    elif case == "both_zero":
        R1[:] = R2[:] = 0
    elif case == "garbage_lower":
        low = np.tril(np.ones((b, b), bool), -1)
        R1[low] = rng.standard_normal(low.sum()) * 1e3
        R2[low] = rng.standard_normal(low.sum()) * 1e3
    elif case == "rank_deficient":
        R1[:, [1, b - 2]] = R2[:, [1, b - 2]] = 0
    elif case == "tiny_column":
        R1[:, 2] *= np.float32(1e-32)
        R2[:, 2] *= np.float32(1e-32)
    else:
        raise ValueError(case)
    return R1, R2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,row_start", [(37, 5, 0), (64, 8, 3), (512, 128, 0)])
def test_cuda_panel_qr_matches_plain(rng, cuda, m, b, row_start):
    A = t(rng.standard_normal((3, m, b)).astype(np.float32)).to(cuda)
    got = tpanel.panel_qr(A, row_start)
    close(got, tref.panel_qr(A, row_start))
    assert all(torch.equal(a[1], o) for a, o in
               zip(got, tpanel.panel_qr(A[1], row_start)))


def _panels(rng, P, m, b, zero_col=None):
    A = rng.standard_normal((P, m, b)).astype(np.float32)
    if zero_col is not None:
        A[:, :, zero_col] = 0.0
    return t(A)


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,row_start,zero_col", [
    (4096, 128, 0, None),     # the tall cell's panel: a team of 16 blocks
    (4096, 128, 3968, None),  # a late panel: one block holds every pivot
    (512, 128, 384, None),    # the square cell's panel: a team of 2
    (1000, 96, 17, None),     # odd row start, ragged slabs
    (8192, 128, 0, None),     # slabs too large for shared memory
    (512, 128, 0, 5),         # a zero column: tau = 0
    (512, 128, 500, None),    # row start past m - b: R's rows clamped
])
def test_cuda_panel_qr_team_matches_plain(rng, cuda, m, b, row_start, zero_col):
    """K1's lane team within tolerance of the plain version at the shapes
    that make the team hard, and a lane alone bit-equal to the same lane
    of a two-lane launch."""
    C = backend.team_blocks(m, b)
    assert (C > 1) == (m >= 512)
    assert backend.team_slab_in_smem(m, b, C) == (m != 8192)
    A = _panels(rng, 2, m, b, zero_col).to(cuda)
    got = tpanel.panel_qr(A, row_start)
    close(got, tref.panel_qr(A, row_start))
    if zero_col is not None:
        assert torch.all(got[1][:, zero_col, zero_col] == 0)  # T = tau = 0
    assert all(torch.equal(a[1], o) for a, o in
               zip(got, tpanel.panel_qr(A[1], row_start)))


@pytest.mark.cuda
def test_cuda_panel_qr_one_lane_equals_eight(rng, cuda):
    """A one-lane launch (a REBUILD replay) gives each lane the bits it has
    in an 8-lane launch, at the tall cell's panel and row starts."""
    P, m, b = 8, 4096, 128
    A = _panels(rng, P, m, b).to(cuda)
    rs = torch.tensor([3968, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    wide = tpanel.panel_qr(A, rs)
    for k in range(P):
        one = tpanel.panel_qr(A[k], int(rs[k]))
        assert all(torch.equal(w[k], o) for w, o in zip(wide, one)), k


@pytest.mark.cuda
@pytest.mark.parametrize("m,b", [(37, 5), (512, 128), (1000, 96), (4096, 128),
                                 (8192, 128), (20000, 100)])
def test_cuda_team_rule_matches_the_kernel(cuda, m, b):
    """The wrappers' team size and shared memory are the kernel's, and the
    card holds at least one team at once."""
    C = backend.team_blocks(m, b)
    assert tpanel.smem_bytes(m, b, C) == backend.team_smem_bytes(
        m, b, C, backend.team_slab_in_smem(m, b, C))
    assert (tpanel.work_floats(m, b, C) == 0) == backend.team_slab_in_smem(m, b, C)
    assert tpanel.max_active_clusters(m, b) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,n", [(37, 5, 13), (256, 128, 300)])
def test_cuda_wy_apply_matches_plain(rng, cuda, m, b, n):
    Y = t(rng.standard_normal((2, m, b)).astype(np.float32) * 0.1).to(cuda)
    T = t(np.triu(rng.standard_normal((2, b, b))).astype(np.float32) * 0.1).to(cuda)
    C = t(rng.standard_normal((2, m, n + 3)).astype(np.float32)).to(cuda)[..., 3:]
    got = twy.wy_apply(Y, T, C)
    close(got, tref.wy_apply(Y, T, C))
    assert torch.equal(got[1], twy.wy_apply(Y[1], T[1], C[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(5, 11), (128, 600)])
def test_cuda_stacked_kernels_match_plain(rng, cuda, b, n):
    R1 = t(np.stack([qr_factor(rng, b) for _ in range(4)])).to(cuda)
    R2 = t(np.stack([qr_factor(rng, b) for _ in range(4)])).to(cuda)
    Y2, T, R = tstacked.stacked_qr(R1, R2)
    close((Y2, T, R), tref.stacked_qr(R1, R2))
    assert all(torch.equal(a[2], o) for a, o in
               zip((Y2, T, R), tstacked.stacked_qr(R1[2], R2[2])))
    Ct = t(rng.standard_normal((4, b, n)).astype(np.float32)).to(cuda)
    Cb = t(rng.standard_normal((4, b, n)).astype(np.float32)).to(cuda)
    got = tstacked.stacked_apply(Y2, T, Ct, Cb)
    close(got, tref.stacked_apply(Y2, T, Ct, Cb))
    assert all(torch.equal(a[3], o) for a, o in
               zip(got, tstacked.stacked_apply(Y2[3], T[3], Ct[3], Cb[3])))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [5, 33, 100, 127, 128])
def test_cuda_stacked_qr_edges(rng, cuda, b):
    """K3 within tolerance of the plain version, lane by lane, on a random
    pair and every edge input, at b off and on the 4-row groups and the
    8-column warps of the kernel's layout."""
    pairs = [(qr_factor(rng, b), qr_factor(rng, b))]
    pairs += [stacked_edge_pair(rng, case, b) for case in STACKED_EDGES]
    Rt = t(np.stack([top for top, _ in pairs])).to(cuda)
    Rb = t(np.stack([bot for _, bot in pairs])).to(cuda)
    got = tstacked.stacked_qr(Rt, Rb)
    want = tref.stacked_qr(Rt, Rb)
    for p in range(len(pairs)):
        close(tuple(x[p] for x in got), tuple(x[p] for x in want))
    assert all(bool(torch.isfinite(x).all()) for x in got)


@pytest.mark.cuda
def test_cuda_stacked_qr_lane_bits(rng, cuda):
    """A lane alone equals its lane of an 8-lane launch; and with the
    stacks that ft_tsqr_level gives a butterfly pair at each level (both
    lanes stack the same two R factors in the same order), the two lanes'
    outputs are bit-equal."""
    P, b = 8, 128
    R = t(np.stack([qr_factor(rng, b) for _ in range(P)])).to(cuda)
    for lvl in range(3):
        g = 1 << lvl
        top = R[[p & ~g for p in range(P)]].contiguous()
        bot = R[[p | g for p in range(P)]].contiguous()
        out = tstacked.stacked_qr(top, bot)
        for p in range(P):
            assert all(torch.equal(x[p], x[p ^ g]) for x in out), (lvl, p)
    R2 = R.flip(0).contiguous()
    wide = tstacked.stacked_qr(R, R2)
    for k in (0, 5):
        one = tstacked.stacked_qr(R[k], R2[k])
        assert all(torch.equal(w[k], o) for w, o in zip(wide, one)), k


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,n", [(37, 4, 13), (130, 33, 1), (200, 100, 67),
                                   (300, 128, 259), (129, 128, 128)])
def test_cuda_wy_apply_edges(rng, cuda, m, b, n):
    """K2 at the shapes its tiling makes hard (b in {4, 33, 100, 128}, n
    off the tile and off 4, m off the 128-row blocks and 16-row slices, one
    column), on a strided window: within tolerance of the plain version,
    and bit-equal for a lane alone and for every column tile."""
    Y = t(rng.standard_normal((3, m, b)).astype(np.float32) * 0.1).to(cuda)
    T = t(np.triu(rng.standard_normal((3, b, b))).astype(np.float32) * 0.1).to(cuda)
    C = t(rng.standard_normal((3, m, n + 3)).astype(np.float32)).to(cuda)[..., 3:]
    got = twy.wy_apply(Y, T, C)
    close(got, tref.wy_apply(Y, T, C))
    assert torch.equal(got[2], twy.wy_apply(Y[2], T[2], C[2]))
    for bn in backend.TILE_BNS:
        assert torch.equal(got, twy.wy_apply(Y, T, C, bn=bn)), bn


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(4, 1), (33, 70), (100, 259), (128, 130)])
def test_cuda_stacked_apply_edges(rng, cuda, b, n):
    """K4 at odd b and n: within tolerance of the plain version, and
    bit-equal for a lane alone and for every column tile."""
    Y2 = t(np.triu(rng.standard_normal((3, b, b))).astype(np.float32) * 0.1).to(cuda)
    T = t(np.triu(rng.standard_normal((3, b, b))).astype(np.float32) * 0.1).to(cuda)
    Ct = t(rng.standard_normal((3, b, n)).astype(np.float32)).to(cuda)
    Cb = t(rng.standard_normal((3, b, n)).astype(np.float32)).to(cuda)
    got = tstacked.stacked_apply(Y2, T, Ct, Cb)
    close(got, tref.stacked_apply(Y2, T, Ct, Cb))
    assert all(torch.equal(a[1], o) for a, o in
               zip(got, tstacked.stacked_apply(Y2[1], T[1], Ct[1], Cb[1])))
    for bn in backend.TILE_BNS:
        assert all(torch.equal(a, o) for a, o in
                   zip(got, tstacked.stacked_apply(Y2, T, Ct, Cb, bn=bn))), bn


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["wy_apply", "stacked_apply"])
def test_cuda_narrow_launch_equals_wide(rng, cuda, op):
    """One lane alone (a narrow column tile) is bit-equal to the same lane
    of an 8-lane launch (a wide tile), as a REBUILD replay needs."""
    P, m, b, n = 8, 512, 128, 4096
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert backend.tile_bn(1, n, sms) < backend.tile_bn(P, n, sms)
    if op == "wy_apply":
        Y, T, _ = tpanel.panel_qr(
            t(rng.standard_normal((P, m, b)).astype(np.float32)).to(cuda), 0)
        C = t(rng.standard_normal((P, m, n)).astype(np.float32)).to(cuda)
        wide = (twy.wy_apply(Y, T, C),)
        one = [(twy.wy_apply(Y[k], T[k], C[k]),) for k in range(P)]
    else:
        R = t(np.stack([qr_factor(rng, b) for _ in range(2 * P)])).to(cuda)
        Y2, T, _ = tstacked.stacked_qr(R[:P].contiguous(), R[P:].contiguous())
        Ct = t(rng.standard_normal((P, b, n)).astype(np.float32)).to(cuda)
        Cb = t(rng.standard_normal((P, b, n)).astype(np.float32)).to(cuda)
        wide = tstacked.stacked_apply(Y2, T, Ct, Cb)
        one = [tstacked.stacked_apply(Y2[k], T[k], Ct[k], Cb[k]) for k in range(P)]
    for k in range(P):
        assert all(torch.equal(w[k], o) for w, o in zip(wide, one[k])), k


@pytest.mark.cuda
def test_cuda_rejects_other_dtypes(cuda):
    with pytest.raises(NotImplementedError):
        ops.panel_qr(torch.zeros(8, 4, device=cuda, dtype=torch.float64), 0)


@pytest.mark.cuda
def test_cuda_sweep_matches_cpu_and_runs_every_kernel(rng, cuda):
    P, m_loc, n, b = 4, 32, 64, 8
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32))
    want = caqr_factorize(A, SimComm(P), b, use_scan=False, collect_bundles=True)
    backend.reset_launches()
    got = caqr_factorize(A.to(cuda), SimComm(P), b, use_scan=False,
                         collect_bundles=True)
    stepped = ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply")
    assert all(backend.LAUNCHES[op] > 0 for op in stepped), backend.LAUNCHES
    close(got.R, want.R)
    close(tuple(got.bundles[:3]), tuple(want.bundles[:3]))
    assert bool((got.R == got.R[:1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("level", [0, 1, 2])
def test_cuda_kill_and_recover_is_bitwise_clean(rng, cuda, level):
    P, m_loc, b, n = 8, 32, 8, 24
    comm = SimComm(P)
    A = t(rng.standard_normal((P, m_loc, b + n)).astype(np.float32)).to(cuda)
    fac = ft_tsqr(A[..., :b], comm)
    C = A[..., b:]
    clean = recovery.run_ft_trailing(C, fac, comm)
    faulty = recovery.run_ft_trailing(C, fac, comm, fail_at_level=level,
                                      failed_lane=3, A_stacked=C)
    assert torch.equal(clean, faulty)


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,b,row_start", [(37, 45, 5, 2), (64, 200, 8, 60),
                                             (512, 300, 128, 0),
                                             (512, 640, 128, 384),
                                             (8192, 160, 128, 7)])
def test_cuda_panel_qr_apply_matches_plain_and_k1_k2(rng, cuda, m, w, b,
                                                     row_start):
    """K5 within tolerance of its plain version, and bit-equal to K1 then
    K2, whose device code it shares."""
    W = t(rng.standard_normal((3, m, w + 3)).astype(np.float32)).to(cuda)[..., 3:]
    got = ops.panel_qr_apply(W, row_start, b)
    close(got, tref.panel_qr_apply(W, row_start, b))
    Y, T, R = ops.panel_qr(W[..., :b], row_start)
    C = ops.wy_apply(Y, T, W)
    r0 = min(max(row_start, 0), m - b)
    for g, want in zip(got, (Y, T, R, C, C[:, r0:r0 + b])):
        assert torch.equal(g, want)
    assert all(torch.equal(a[2], o) for a, o in
               zip(got, ops.panel_qr_apply(W[2], row_start, b)))


@pytest.mark.cuda
@pytest.mark.parametrize("P,m_loc,w,b,k", [(2, 16, 21, 5, 0), (4, 24, 50, 8, 4),
                                           (8, 32, 70, 8, 9)])
def test_cuda_fused_panel_matches_plain(rng, cuda, P, m_loc, w, b, k):
    """K6 within tolerance of fused_panel_math over the plain forms, at
    small odd shapes, including a panel whose root is past lane 0."""
    L = P.bit_length() - 1
    win = t(rng.standard_normal((P, m_loc, w)).astype(np.float32)).to(cuda)
    got = ops.fused_panel(win, k, b=b, m_loc_pad=m_loc, levels=L)
    want = tref.fused_panel(win, k, b=b, m_loc_pad=m_loc, levels=L)
    fields = [f for f in want if f != "tops"]
    close(tuple(got[f] for f in fields), tuple(want[f] for f in fields))
    assert all(torch.equal(a, b_) for a, b_ in zip(got["tops"], want["tops"]))


def _assert_states_equal(got, want, tag):
    ga, wa = tstate.flat_arrays(got), tstate.flat_arrays(want)
    assert ga.keys() == wa.keys(), tag
    for key in ga:
        assert ga[key].dtype == wa[key].dtype, (tag, key)
        assert torch.equal(ga[key].cpu(), wa[key].cpu()), (tag, key)
    assert got.cursor == want.cursor, tag


@pytest.mark.cuda
@pytest.mark.parametrize("P,m_loc,n,b", [(4, 8, 16, 4), (4, 6, 10, 4),
                                         (4, 4, 40, 4), (8, 32, 256, 16),
                                         (4, 512, 1024, 128)])
def test_cuda_fused_equals_stepped_bitwise(rng, cuda, P, m_loc, n, b):
    """run_panel_fused (one K6 launch a panel) == the panel's sweep_steps
    (K1-K4), bit for bit at every panel boundary and after finalize."""
    comm = SimComm(P)
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    s_f = s_s = tstate.initial_sweep_state(comm, A, b)
    pts = tstate.panel_points(s_s.geom)
    backend.reset_launches()
    while s_f.cursor is not None:
        s_f = tstate.run_panel_fused(comm, s_f)
        s_s = tstate.run_steps(comm, s_s, pts)
        _assert_states_equal(s_f, s_s, s_s.cursor)
    assert backend.LAUNCHES["fused_panel"] == s_s.geom.n_panels
    for g, w in zip(tstate.finalize(comm, s_f), tstate.finalize(comm, s_s)):
        got = [g] if isinstance(g, torch.Tensor) else list(g)
        want = [w] if isinstance(w, torch.Tensor) else list(w)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("point,lane", [(sweep_point(1, "tsqr", 1), 0),
                                        (sweep_point(6, "trailing", 2), 5),
                                        (sweep_point(9, "leaf"), 3)])
def test_cuda_ft_kill_recovered_bitwise(rng, cuda, point, lane):
    """A lane killed in the sweep and rebuilt through one-lane K1/K2/K4
    launches gives R, factors and bundles bit-equal to the failure-free
    sweep (P = 8, the root walks lanes 0-3)."""
    P, m_loc, n, b = 8, 32, 128, 8
    comm = SimComm(P)
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    ref = caqr_factorize(A, comm, b, collect_bundles=True, use_scan=False)
    got = ft_caqr_sweep(A, comm, b,
                        schedule=FailureSchedule(events={point: [lane]}))
    for x, y in zip((got.R, *got.factors, *got.bundles),
                    (ref.R, *ref.factors, *ref.bundles)):
        assert torch.equal(x, y)
    (event,) = got.events
    assert event.point == point and event.lane == lane


def _flat(res):
    return (res.R, *res.factors, *res.bundles)


def _bitwise(got, want):
    return all(torch.equal(x, y) for x, y in zip(_flat(got), _flat(want)))


# P = 8 lanes of 32 rows at b = 8: 16 panels, the root walks lanes 0-3
ONLINE = (8, 32, 128, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["stepped", "fused", "async"])
def test_cuda_online_equals_scheduled(rng, cuda, path):
    """The online path (a ScriptedKiller, found by the NaN sentinel) ==
    the scheduled sweep with the same kills, bits and ledgers; the fused
    path's boundaries are panel ends, so its kills sit there."""
    P, m_loc, n, b = ONLINE
    comm = SimComm(P)
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    if path == "fused":
        kills = {sweep_point(3, "trailing", 2): [1],
                 sweep_point(9, "trailing", 2): [6]}
        kw = dict(fused=True)
    else:
        kills = {sweep_point(1, "tsqr", 1): [0],
                 sweep_point(6, "trailing", 2): [5], sweep_point(9, "leaf"): [3]}
        kw = dict(async_segments=path == "async")
    sched = ft_caqr_sweep(A, comm, b, schedule=FailureSchedule(events=kills))
    backend.reset_launches()
    got = ft_caqr_sweep_online(A, comm, b,
                               fault_hooks=[ScriptedKiller(kills)], **kw)
    assert _bitwise(got, sched)
    assert [(e.point, e.lane, e.reads) for e in got.events] == \
        [(e.point, e.lane, e.reads) for e in sched.events]
    if path == "fused":
        assert backend.LAUNCHES["fused_panel"] == n // b
    else:
        assert backend.LAUNCHES["stacked_qr"] > 0
        assert backend.LAUNCHES["fused_panel"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_cuda_mds_joint_decode_is_bitwise(rng, cuda, fused):
    """MDSScheme(f=2): a whole former buddy pair and a non-buddy pair
    killed at one boundary each, decoded jointly on the card: bit-equal to
    the failure-free sweep."""
    P, m_loc, n, b = ONLINE
    comm = SimComm(P)
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    ref = caqr_factorize(A, comm, b, collect_bundles=True, use_scan=False)
    kills = {sweep_point(4, "trailing", 2): [2, 3],
             sweep_point(10, "trailing", 2): [1, 6]}
    got = ft_caqr_sweep_online(A, comm, b, scheme=MDSScheme(f=2),
                               fused=fused,
                               fault_hooks=[ScriptedKiller(kills)])
    assert _bitwise(got, ref)
    assert [e.lane for e in got.events] == [2, 3, 1, 6]
    assert all(e.reads["coded.parity1"] == P + 1 for e in got.events)


@pytest.mark.cuda
def test_cuda_async_equals_sync_without_kills(rng, cuda):
    P, m_loc, n, b = ONLINE
    comm = SimComm(P)
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    sync = SweepOrchestrator(A, comm, b, segment_points=2).run()
    orch = SweepOrchestrator(A, comm, b, segment_points=2,
                             async_segments=True)
    assert _bitwise(orch.run(), sync)
    assert orch.segments_run == orch.boundaries


@pytest.mark.cuda
def test_cuda_shrink_scheduled_equals_online(rng, cuda):
    """SHRINK at P = 8: the adopter's slice doubles, so the second epoch
    runs K1 and K6 at twice the padded lane height; scheduled (stepped)
    and online (fused) give the same R bits."""
    P, m_loc, n, b = ONLINE
    comm = SimComm(P)
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    point = sweep_point(5, "trailing", 2)
    sched = ft_caqr_sweep(A, comm, b, semantics=Semantics.SHRINK,
                          schedule=FailureSchedule(events={point: [3]}))
    online = ft_caqr_sweep_online(A, comm, b, semantics=Semantics.SHRINK,
                                  fused=True,
                                  fault_hooks=[ScriptedKiller({point: [3]})])
    assert torch.equal(sched.R, online.R)
    assert sched.transitions == online.transitions
    assert online.world.n_live == P - 1
    R = online.R.double().cpu()
    A64 = A.reshape(-1, n).double().cpu()
    G = A64.T @ A64
    assert float((R.T @ R - G).abs().max() / G.abs().max()) < 1e-4
