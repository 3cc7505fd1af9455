"""The port's CUDA kernels K1-K6 against their plain PyTorch versions on
the card, and the port's bitwise contracts there (fused == stepped, kill
== failure-free, online == scheduled, async == sync, MDS decode ==
failure-free, SHRINK scheduled == online) and the QR service's (kill ==
failure-free, drain_batched == continuous, every R == its solo sweep),
and one process per lane (``repro_torch.launch.spmd_qr``: four ranks in a
gloo group on the one card) == the single-process run, bit for bit, and
(eight ranks) the online and elastic sweeps over the ranks == the same
orchestrator in one process.
Above 128 columns: every instantiation of the products' tile routine ==
the oracle of its summation order (``wide.gemm_order``), and K5/K6's wide
kernel == the stepped wide route.
Needs an NVIDIA GPU with nvcc; every test skips without one.

Imports neither JAX nor the JAX package, so it also runs on a machine
with the card and no JAX: ``python -m pytest -q tests/test_torch_cuda.py``.
Tolerance: the f32 pair of ``repro_torch.kernels.ref.tolerances``, as
``atol = 3e-4 * max(1, max|plain|)``.
"""
import os

# cuBLAS reads its workspace setting when CUDA starts; the training tests'
# deterministic mode needs the fixed one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.core import SimComm, block_row_layout, caqr_factorize, ft_tsqr, recovery  # noqa: E402
from repro_torch.core import panel_geometry, sweep_geometry  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    FailureSchedule,
    MDSScheme,
    ScriptedKiller,
    Semantics,
    SweepOrchestrator,
    ft_caqr_sweep,
    ft_caqr_sweep_online,
    sweep_point,
)
from repro_torch.ft.online import state as tstate  # noqa: E402
from repro_torch.ft.online.detect import DelayedDetector, NaNSentinelDetector  # noqa: E402
from repro_torch.kernels import backend, ops  # noqa: E402
from repro_torch.kernels import fused_sweep as tfused  # noqa: E402
from repro_torch.kernels import panel_qr as tpanel  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import stacked_qr as tstacked  # noqa: E402
from repro_torch.kernels import wide as twide  # noqa: E402
from repro_torch.kernels import wy_apply as twy  # noqa: E402
from repro_torch.launch import spmd_qr  # noqa: E402
from repro_torch.serve import QRService  # noqa: E402

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


# the service at a small size: P = 4, b = 8, one bucket of 128 x 40
SERVE_P, SERVE_B, SERVE_BUCKET = 4, 8, (32, 40)
SERVE_SHAPES = [(100, 30), (128, 38), (20, 36), (90, 17), (60, 40)]


def _serve(reqs, slots, kill=False, batched=False):
    svc = QRService(SimComm(SERVE_P), panel_width=SERVE_B,
                    buckets=[SERVE_BUCKET], max_slots=slots)
    rids = [svc.submit(A, rhs) for A, rhs in reqs]
    if batched:
        return rids, svc.drain_batched()
    if kill:
        svc.tick()
        svc.tick()
        (slot, *_) = [s for s in svc.slots if s is not None]
        assert slot.state.A.is_cuda
        svc.kill_lane(2)
    return rids, svc.run_until_drained()


@pytest.mark.cuda
def test_cuda_qr_service_kill_and_drain_bitwise(rng, cuda):
    """The service on the card: a lane killed mid-batch heals to the
    failure-free bits, drain_batched equals continuous batching, and every
    R equals a solo sweep of the bucket-padded matrix; K1-K4 launched."""
    reqs = []
    for i, (m, n) in enumerate(SERVE_SHAPES):
        A = rng.standard_normal((m, n)).astype(np.float32)
        rhs = rng.standard_normal((m, 2)).astype(np.float32) if i == 0 else None
        reqs.append((A, rhs))
    backend.reset_launches()
    rids, clean = _serve(reqs, 8)
    assert all(backend.LAUNCHES[op] > 0 for op in
               ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply"))
    _, killed = _serve(reqs, 4, kill=True)
    _, drained = _serve(reqs, 8, batched=True)
    assert sum(len(r.events) for r in killed.values()) >= 1
    for rid, (A, rhs) in zip(rids, reqs):
        for other in (killed, drained):
            np.testing.assert_array_equal(other[rid].R, clean[rid].R)
            if rhs is not None:
                np.testing.assert_array_equal(other[rid].x, clean[rid].x)
        A_aug = A if rhs is None else np.concatenate([A, rhs], axis=1)
        solo = caqr_factorize(
            block_row_layout(A_aug, SERVE_P, *SERVE_BUCKET), SimComm(SERVE_P),
            SERVE_B, use_scan=False, collect_bundles=True)
        k, n = min(A.shape), A.shape[1]
        np.testing.assert_array_equal(clean[rid].R, solo.R[0, :k, :n].cpu().numpy())
    A, rhs = reqs[0]
    x_ref, *_ = np.linalg.lstsq(A.astype(np.float64), rhs.astype(np.float64),
                                rcond=None)
    np.testing.assert_allclose(clean[rids[0]].x, x_ref, atol=1e-3)


@pytest.fixture
def deterministic(cuda):
    """torch's deterministic mode (the scatter-adds of the embedding's and
    the loss's backward), restored afterwards."""
    before = torch.are_deterministic_algorithms_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    yield
    torch.use_deterministic_algorithms(before)
    torch.utils.deterministic.fill_uninitialized_memory = fill


@pytest.mark.cuda
def test_cuda_ftrun_failure_free_twice_and_kill_bitwise(deterministic):
    """The smoke config's FTTrainer (caqr_muon, 4 lanes, b = 16) on the
    card: two failure-free runs bit-equal, and a lane killed inside step
    2's first sweep healed to the same bits; K1-K4 launched, K5/K6 not."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import TrainConfig
    from repro_torch.train.ftrun import FTTrainer, StepSweepKiller

    cfg = get_smoke("tinyllama-1.1b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=1)
    tcfg = TrainConfig(steps=4, lr=1e-2, warmup=2, n_lanes=4, diskless_every=2,
                       log_every=100, optimizer="caqr_muon")
    backend.reset_launches()
    runs = [FTTrainer(cfg, tcfg, dcfg) for _ in range(2)]
    hists = [tr.run() for tr in runs]
    assert all(backend.LAUNCHES[op] > 0 for op in
               ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply"))
    assert backend.LAUNCHES["panel_qr_apply"] == backend.LAUNCHES["fused_panel"] == 0
    killer = StepSweepKiller(at_step=2, lane=1)
    killed = FTTrainer(cfg, tcfg, dcfg, qr_fault_hooks=[killer])
    hists.append(killed.run())
    runs.append(killed)
    assert killer.fired and len(killed.engine.events) == 1
    for tr, hist in zip(runs[1:], hists[1:]):
        assert [h["loss"] for h in hist] == [h["loss"] for h in hists[0]]
        assert all(torch.equal(a, b) for a, b in
                   zip(tree.leaves(tr.state.params), tree.leaves(runs[0].state.params)))


@pytest.mark.cuda
@pytest.mark.parametrize("m_loc,n,b", [(1408, 128, 128), (512, 128, 128), (512, 4, 4)])
def test_cuda_kernels_at_train_shapes_match_plain(rng, cuda, m_loc, n, b):
    """K1-K4 at the FT trainer's sweep shapes (TinyLlama's w_in and wq
    sweeps over 4 lanes, and a rank-4 PowerSGD projection), on 4 lanes and
    one lane (the REBUILD replay)."""
    P = 4
    X = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    panel = X[..., :b].contiguous()
    pairs = [p ^ 1 for p in range(P)]
    for args in ((panel, 0), (panel, m_loc - b), (panel[2], 0)):
        close(ops.panel_qr(*args), tref.panel_qr(*args))
    Y, T, R = ops.panel_qr(panel, 0)
    for args in ((Y, T, X), (Y[1], T[1], X[1])):
        close(ops.wy_apply(*args), tref.wy_apply(*args))
    close(ops.stacked_qr(R, R[pairs].contiguous()), tref.stacked_qr(R, R[pairs].contiguous()))
    Y2, T2, _ = ops.stacked_qr(R, R[pairs].contiguous())
    Ct = X[:, :b].contiguous()
    args = (Y2, T2, Ct, Ct[pairs].contiguous())
    close(ops.stacked_apply(*args), tref.stacked_apply(*args))


@pytest.mark.cuda
def test_cuda_moe_ftrun_failure_free_twice_and_expert_kill_bitwise(deterministic):
    """mixtral's smoke config (sliding window, 4 experts top-2) through the
    FTTrainer (caqr_muon, 4 lanes, b = 16) on the card: two failure-free
    runs bit-equal, and a lane killed mid-sweep inside an expert bank's
    sweep healed to the same bits by one single-source event; K1-K4
    launched, K5/K6 not."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.train import TrainConfig
    from repro_torch.train.ftrun import FTTrainer, StepSweepKiller

    cfg = get_smoke("mixtral-8x22b")
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=1)
    tcfg = TrainConfig(steps=3, lr=1e-2, warmup=2, n_lanes=4, diskless_every=2,
                       log_every=100, optimizer="caqr_muon")
    backend.reset_launches()
    runs = [FTTrainer(cfg, tcfg, dcfg) for _ in range(2)]
    hists = [tr.run() for tr in runs]
    assert len(runs[0]._tasks) == 24
    assert all(backend.LAUNCHES[op] > 0 for op in
               ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply"))
    assert backend.LAUNCHES["panel_qr_apply"] == backend.LAUNCHES["fused_panel"] == 0
    killer = StepSweepKiller(at_step=2, lane=1, task="groups/l0/ffn/.w_gate#3",
                             point=sweep_point(2, "tsqr", 1))
    killed = FTTrainer(cfg, tcfg, dcfg, qr_fault_hooks=[killer])
    hists.append(killed.run())
    runs.append(killed)
    ev = killed.engine.events
    assert killer.fired and len(ev) == 1 and ev[0].reads and 1 not in ev[0].reads.values()
    for tr, hist in zip(runs[1:], hists[1:]):
        assert [h["loss"] for h in hist] == [h["loss"] for h in hists[0]]
        for a, b in ((tr.state.params, runs[0].state.params),
                     (tr.state.opt_state, runs[0].state.opt_state)):
            assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("m_loc,n,b", [(4096, 6144, 128), (1536, 6144, 128),
                                       (1536, 1024, 128), (1536, 8, 8)])
def test_cuda_kernels_at_moe_shapes_match_plain(rng, cuda, m_loc, n, b):
    """K1-K4 at the shapes of mixtral-8x22b's sweeps over 4 lanes (an expert
    slice, wq, wk and the router, whose one panel is as wide as the
    matrix), on 4 lanes and one lane (the REBUILD replay): K1 at row start
    0 and at the last panel's, K2 over the whole window, a middle one and
    the last panel's."""
    P = 4
    X = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    panel = X[..., :b].contiguous()
    pairs = [p ^ 1 for p in range(P)]
    k_last = sweep_geometry(P, m_loc, n, b).n_panels - 1
    last = panel_geometry(SimComm(P), k_last, b, m_loc)[2]
    for args in ((panel, 0), (panel, last), (panel[2], 0), (panel[0], int(last[0]))):
        close(ops.panel_qr(*args), tref.panel_qr(*args))
    Y, T, R = ops.panel_qr(panel, 0)
    for w in sorted({n, max(n // 2, 1), b}):
        C = X[..., n - w:].contiguous()
        close(ops.wy_apply(Y, T, C), tref.wy_apply(Y, T, C))
    close(ops.wy_apply(Y[1], T[1], X[1]), tref.wy_apply(Y[1], T[1], X[1]))
    close(ops.stacked_qr(R, R[pairs].contiguous()), tref.stacked_qr(R, R[pairs].contiguous()))
    Y2, T2, _ = ops.stacked_qr(R, R[pairs].contiguous())
    Ct = X[:, :b].contiguous()
    args = (Y2, T2, Ct, Ct[pairs].contiguous())
    close(ops.stacked_apply(*args), tref.stacked_apply(*args))


# -- panel widths above 128: the blocked routes of kernels/wide.py ----------


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,row_start", [
    (512, 256, 0),      # two full sub-panels
    (1000, 200, 37),    # a ragged last sub-panel (128 + 72), odd row start
    (4096, 256, 3840),  # the last panel's row start of the b = 256 sweep
    (600, 300, 500),    # row start past m - b: R's rows clamped to [300, 600)
])
def test_cuda_wide_panel_qr_matches_plain(rng, cuda, m, b, row_start):
    """K1 above 128 columns within tolerance of the plain version, in one
    launch of csrc/panel_qr_wide.cu (K1's team on sub-panels, the products
    between them as tile phases), with no torch.matmul or geqrf on it: one
    call counts one launch of panel_qr and no sub-launch."""
    A = _panels(rng, 2, m, b).to(cuda)
    backend.reset_launches()
    got = ops.panel_qr(A, row_start)
    assert backend.LAUNCHES["panel_qr"] == 1 and backend.LAUNCHES["wy_apply"] == 0
    assert not any(backend.SUB_LAUNCHES.values()), backend.SUB_LAUNCHES
    assert backend.probe_report()["panel_qr"]["engine"] == "cuda"
    close(got, tref.panel_qr(A, row_start))


# (P, m, b, row starts): the Muon path's K1 shapes, the b = 256 sweep's
# first and last panels, a ragged (1000, 200) at row start 37, b = 384,
# and the CPU tests' shapes (square panels, a 44-column last sub-panel,
# three lanes from row 0, 37 and past m - b)
WIDE_K1 = [(1, 2048, 2048, [0]), (1, 5632, 2048, [0]), (1, 512, 256, [0]),
           (1, 768, 256, [0]), (8, 4096, 256, [0] * 8),
           (8, 4096, 256, [3840] + [0] * 7), (1, 1000, 200, [37]),
           (2, 1024, 384, [0, 100]), (1, 256, 256, [0]), (1, 300, 300, [0]),
           (1, 640, 300, [17]), (3, 400, 200, [0, 37, 350])]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WIDE_K1, ids=lambda c: "-".join(map(str, c[:3])))
def test_cuda_wide_panel_qr_one_launch_equals_composed(rng, cuda, case):
    """The one launch equals the composed route (K1's team launch a
    sub-panel, K2's wide route between them, the T join's wide_gemm
    products) bit for bit, and only the composed route counts
    sub-launches."""
    P, m, b, rs = case
    A = _panels(rng, P, m, b).to(cuda)
    rs = torch.tensor(rs, dtype=torch.int32)
    backend.reset_launches()
    got = tpanel.panel_qr(A, rs)
    assert backend.LAUNCHES["panel_qr"] == 1
    assert not any(backend.SUB_LAUNCHES.values()), backend.SUB_LAUNCHES
    want = tpanel.panel_qr_composed(A, rs)
    assert backend.SUB_LAUNCHES["panel_qr_kernel"] == -(-b // 128)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [256, 300])
def test_cuda_wide_stacked_qr_one_launch_equals_composed(rng, cuda, b):
    """K3 above 128 columns is one launch of K1's wide kernel on the
    stacks (one count of stacked_qr, no sub-launch), equal to the
    composed route bit for bit."""
    R = t(np.stack([qr_factor(rng, b) for _ in range(4)])).to(cuda)
    Rt, Rb = R[:2].contiguous(), R[2:].contiguous()
    backend.reset_launches()
    got = tstacked.stacked_qr(Rt, Rb)
    assert backend.LAUNCHES["stacked_qr"] == 1 and backend.LAUNCHES["panel_qr"] == 0
    assert not any(backend.SUB_LAUNCHES.values()), backend.SUB_LAUNCHES
    want = tstacked.stacked_qr_composed(Rt, Rb)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    close(got, tref.stacked_qr(Rt, Rb))


@pytest.mark.cuda
def test_cuda_wide_launch_the_card_cannot_hold_raises(rng, cuda, monkeypatch):
    """When the card cannot hold a team of a wide launch (here: the
    launches' occupancy queries report so), K1, K3, K5 and K6 above 128
    raise and launch nothing: no composed route or stepped kernel stands
    in."""
    def refused(*args):
        raise RuntimeError("the card cannot hold a cluster (test)")

    monkeypatch.setattr(tpanel, "wide_launch_shape", refused)
    monkeypatch.setattr(tfused, "blocks_per_sm", lambda *args: 0)
    A = _panels(rng, 2, 512, 256).to(cuda)
    R = t(np.stack([qr_factor(rng, 256) for _ in range(2)])).to(cuda)
    backend.reset_launches()
    calls = (lambda: ops.panel_qr(A, 0), lambda: ops.stacked_qr(R, R),
             lambda: ops.panel_qr_apply(A, 0, 256),
             lambda: ops.fused_panel(A, 0, b=256, m_loc_pad=512, levels=1))
    for call in calls:
        with pytest.raises(RuntimeError, match="hold"):
            call()
    torch.cuda.synchronize()
    assert not any(backend.LAUNCHES.values()), backend.LAUNCHES
    assert not any(backend.SUB_LAUNCHES.values()), backend.SUB_LAUNCHES


@pytest.mark.cuda
def test_cuda_wide_one_lane_equals_eight(rng, cuda):
    """At b = 256 a one-lane launch (a REBUILD replay) gives each lane the
    bits of an 8-lane launch: K1 (row starts 0 and the last panel's), K2
    and K4."""
    P, m, b, n = 8, 1024, 256, 600
    A = _panels(rng, P, m, b).to(cuda)
    rs = torch.tensor([768, 0, 0, 0, 0, 0, 0, 0], dtype=torch.int32)
    k1 = tpanel.panel_qr(A, rs)
    C = t(rng.standard_normal((P, m, n)).astype(np.float32)).to(cuda)
    k2 = twy.wy_apply(k1[0], k1[1], C)
    R = t(np.stack([qr_factor(rng, b) for _ in range(2 * P)])).to(cuda)
    Y2, T2, _ = tstacked.stacked_qr(R[:P].contiguous(), R[P:].contiguous())
    Ct = C[:, :b].contiguous()
    Cb = C[:, b:2 * b].contiguous()
    k4 = tstacked.stacked_apply(Y2, T2, Ct, Cb)
    for k in range(P):
        assert all(torch.equal(w[k], o) for w, o in
                   zip(k1, tpanel.panel_qr(A[k], int(rs[k])))), k
        assert torch.equal(k2[k], twy.wy_apply(k1[0][k], k1[1][k], C[k])), k
        assert all(torch.equal(w[k], o) for w, o in
                   zip(k4, tstacked.stacked_apply(Y2[k], T2[k], Ct[k], Cb[k]))), k


@pytest.mark.cuda
def test_cuda_wide_apply_with_random_t(rng, cuda):
    """K2 and K4 at b = 256 read all of T: a random upper-triangular T (not
    Y's own) gives the plain version's function, and the column tile does
    not change a bit. K4's C_top - W comes from the kernel's second store,
    with the bits of that subtraction."""
    P, m, b, n = 2, 700, 256, 300
    Y = t(rng.standard_normal((P, m, b)).astype(np.float32)).to(cuda)
    T = t(np.triu(rng.standard_normal((P, b, b))).astype(np.float32) / 16).to(cuda)
    C = t(rng.standard_normal((P, m, n)).astype(np.float32)).to(cuda)
    got = twy.wy_apply(Y, T, C)
    close(got, tref.wy_apply(Y, T, C))
    Y2 = t(np.triu(rng.standard_normal((P, b, b))).astype(np.float32) / 16).to(cuda)
    Ct = t(rng.standard_normal((P, b, n)).astype(np.float32)).to(cuda)
    Cb = t(rng.standard_normal((P, b, n)).astype(np.float32)).to(cuda)
    got4 = tstacked.stacked_apply(Y2, T, Ct, Cb)
    close(got4, tref.stacked_apply(Y2, T, Ct, Cb))
    assert torch.equal(got4[0], Ct - got4[2])
    for bn in backend.TILE_BNS:
        assert torch.equal(got, twy.wy_apply(Y, T, C, bn=bn)), bn
        assert all(torch.equal(a, o) for a, o in
                   zip(got4, tstacked.stacked_apply(Y2, T, Ct, Cb, bn=bn))), bn


@pytest.mark.cuda
@pytest.mark.parametrize("case", STACKED_EDGES)
def test_cuda_wide_stacked_qr_pair_bits(rng, cuda, case):
    """K3 at b = 256 (K1's blocked route on the stack) within tolerance of
    the plain version on the edge inputs, Y2 exactly upper triangular, and
    the two lanes of a butterfly pair, which stack the same two R factors,
    bit-equal."""
    b = 256
    R1, R2 = stacked_edge_pair(rng, case, b)
    Rt = t(np.stack([R1, R1])).to(cuda)
    Rb = t(np.stack([R2, R2])).to(cuda)
    got = ops.stacked_qr(Rt, Rb)
    close(got, tref.stacked_qr(Rt, Rb))
    assert torch.equal(got[0], got[0].triu())
    assert all(torch.equal(x[0], x[1]) for x in got)


@pytest.mark.cuda
def test_cuda_fused_kernels_launch_wide_panels(rng, cuda):
    """K5 and K6 at b = 256 run as one launch each (LAUNCHES counted, no
    kernel of the stepped routes launched) and equal the stepped wide
    route bit for bit: K5 equals K1 then K2, K6 the panel's sweep steps."""
    P, m, b = 2, 512, 256
    W = t(rng.standard_normal((P, m, 2 * b)).astype(np.float32)).to(cuda)
    backend.reset_launches()
    k5 = ops.panel_qr_apply(W, 0, b)
    k6 = ops.fused_panel(W, 0, b=b, m_loc_pad=m, levels=1)
    assert backend.LAUNCHES["panel_qr_apply"] == backend.LAUNCHES["fused_panel"] == 1
    assert all(backend.LAUNCHES[op] == 0 for op in
               ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply"))
    assert all(n == 0 for n in backend.SUB_LAUNCHES.values())
    assert backend.probe_report()["fused_panel"]["engine"] == "cuda"
    Y, T, R = ops.panel_qr(W[..., :b], 0)
    C = ops.wy_apply(Y, T, W)
    for g, want in zip(k5, (Y, T, R, C, C[:, :b])):
        assert torch.equal(g, want)
    assert torch.equal(k6["leaf_Y"], Y) and torch.equal(k6["C_local"], C)


# -- wide_gemm's summation order, and K5/K6 above 128 ------------------------


def _gemm_case(g, P, M, N, K, how, cuda):
    """Operands of one product: A (P, M, K) and B (P, K, N), each stored
    as given or transposed (a .mT view of its transpose), D, and E."""
    def mat(r, c, transposed):
        x = torch.randn(P, c, r, generator=g) if transposed else torch.randn(P, r, c, generator=g)
        x = x.to(cuda)
        return x.mT if transposed else x
    A = mat(M, K, "At" in how)
    B = mat(K, N, "Bt" in how)
    D = None if "noD" in how else torch.randn(P, M, N, generator=g).to(cuda)
    E = torch.randn(P, M, N, generator=g).to(cuda) if "E" in how else None
    return A, B, D, E


GEMM_CASES = [  # (P, M, N, K, how)
    (8, 256, 300, 5632, "At"), (1, 130, 70, 5000, "At sub"), (2, 97, 65, 17, "sub E"),
    (8, 64, 40, 1, "noD"), (1, 200, 129, 300, "Bt noD sub"),
    (2, 70, 50, 600, "At Bt E"), (1, 1000, 257, 256, "sub"), (3, 33, 260, 513, "noD E"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GEMM_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_wide_gemm_equals_its_order_oracle(cuda, case):
    """wide_gemm at every tile (bn 32/64/128) and split of k (none, the
    plan's, one and two block sums a range) and K5/K6's in-block
    instantiation equal wide_gemm_order_f32 (one thread an element, the
    order as loops) bit for bit: ragged M/N/K, transposed views, sub,
    D = None, the second store, P = 1 and 8; and within tolerance of the
    plain product."""
    P, M, N, K, how = case
    g = torch.Generator().manual_seed(sum(case[:4]))
    A, B, D, E = _gemm_case(g, P, M, N, K, how, cuda)
    sub = "sub" in how
    want = as_tuple(twide.gemm_order(A, B, D, sub=sub, minuend=E))
    close(want, as_tuple(twide.gemm_plain(A, B, D, sub=sub, minuend=E)))
    nblk = twide.kblocks(K)
    for bn in twide.TILES:
        for kbs in sorted({None, nblk, 1, 2}, key=str):
            got = as_tuple(twide.gemm(A, B, D, sub=sub, minuend=E, bn=bn, kbs=kbs))
            assert all(torch.equal(x, y) for x, y in zip(got, want)), (bn, kbs)
    got = as_tuple(tfused.gemm_in_block(A, B, D, sub=sub, minuend=E))
    assert all(torch.equal(x, y) for x, y in zip(got, want)), "in-block"


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,b,row_start", [(1024, 600, 256, 0),
                                             (1000, 450, 200, 37),
                                             (1000, 450, 200, 800)])
def test_cuda_wide_k5_equals_stepped(rng, cuda, m, w, b, row_start):
    """K5 above 128 columns equals the stepped wide route (K1 then K2) bit
    for bit, a lane of an eight-lane launch equals its one-lane launch, and
    the plain version holds it within tolerance."""
    W = t(rng.standard_normal((8, m, w + 3)).astype(np.float32)).to(cuda)[..., 3:]
    rs = torch.tensor([row_start, 0, m - b] + [row_start] * 5, dtype=torch.int32)
    got = ops.panel_qr_apply(W, rs, b)
    close(got, tref.panel_qr_apply(W, rs, b))
    Y, T, R = ops.panel_qr(W[..., :b], rs)
    C = ops.wy_apply(Y, T, W)
    r0 = rs.long().clamp(0, m - b)
    Cp = torch.stack([C[p, r0[p]:r0[p] + b] for p in range(8)])
    for g, want in zip(got, (Y, T, R, C, Cp)):
        assert torch.equal(g, want)
    assert all(torch.equal(a[3], o) for a, o in
               zip(got, ops.panel_qr_apply(W[3], row_start, b)))


@pytest.mark.cuda
@pytest.mark.parametrize("P,m_loc,n", [(2, 512, 1024), (4, 256, 1024), (8, 512, 1024)])
def test_cuda_wide_fused_equals_stepped_bitwise(rng, cuda, P, m_loc, n):
    """run_panel_fused (one wide K6 launch a panel) == the panel's sweep
    steps (K1-K4's wide routes) at b = 256, bit for bit at every panel
    boundary, through consumed lanes and dead groups (the root walks the
    lanes), and each panel's K6 within tolerance of its plain version."""
    b = 256
    comm = SimComm(P)
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    s_f = s_s = tstate.initial_sweep_state(comm, A, b)
    pts = tstate.panel_points(s_s.geom)
    backend.reset_launches()
    while s_f.cursor is not None:
        k = s_f.cursor[0]
        s_f = tstate.run_panel_fused(comm, s_f)
        s_s = tstate.run_steps(comm, s_s, pts)
        _assert_states_equal(s_f, s_s, s_s.cursor)
        win = s_f.window
        want = tref.fused_panel(win, k, b=b, m_loc_pad=s_f.geom.m_loc_pad,
                                levels=s_f.levels)
        close(tuple(getattr(s_f, f) for f in ("leaf_Y", "leaf_T", "C_local",
                                              "C_prime")),
              tuple(want[f] for f in ("leaf_Y", "leaf_T", "C_local", "C_prime")))
    assert backend.LAUNCHES["fused_panel"] == s_s.geom.n_panels
    for g, w in zip(tstate.finalize(comm, s_f), tstate.finalize(comm, s_s)):
        got = [g] if isinstance(g, torch.Tensor) else list(g)
        want = [w] if isinstance(w, torch.Tensor) else list(w)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_cuda_wide_online_fused_with_kills_equals_stepped(rng, cuda):
    """The online sweep at b = 256 with fused segments and panel-end kills
    equals the stepped online sweep and the failure-free sweep bit for
    bit (P = 8, 4 panels)."""
    P, m_loc, n, b = 8, 512, 1024, 256
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32)).to(cuda)
    L = 3
    kills = {sweep_point(0, "trailing", L - 1): [5],
             sweep_point(2, "trailing", L - 1): [3]}
    free = caqr_factorize(A, SimComm(P), b, collect_bundles=True, use_scan=False)
    fused = ft_caqr_sweep_online(A, SimComm(P), b, fused=True,
                                 fault_hooks=[ScriptedKiller(kills)])
    stepped = ft_caqr_sweep_online(A, SimComm(P), b,
                                   fault_hooks=[ScriptedKiller(kills)])
    assert _bitwise(fused, stepped) and _bitwise(fused, free)
    assert [e.lane for e in fused.events] == [5, 3]


@pytest.mark.cuda
def test_cuda_wide_sweep_matches_cpu(rng, cuda):
    """A b = 256 sweep on the card within tolerance of the same sweep on
    the CPU, K1-K4 launched, R replicated bitwise."""
    P, m_loc, n, b = 4, 512, 768, 256
    A = t(rng.standard_normal((P, m_loc, n)).astype(np.float32))
    want = caqr_factorize(A, SimComm(P), b, use_scan=False, collect_bundles=True)
    backend.reset_launches()
    got = caqr_factorize(A.to(cuda), SimComm(P), b, use_scan=False,
                         collect_bundles=True)
    stepped = ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply")
    assert all(backend.LAUNCHES[op] > 0 for op in stepped), backend.LAUNCHES
    assert backend.LAUNCHES["panel_qr_apply"] == backend.LAUNCHES["fused_panel"] == 0
    close(got.R, want.R)
    close(tuple(got.bundles[:3]), tuple(want.bundles[:3]))
    assert bool((got.R == got.R[:1]).all())


# -- one process per lane on the card -------------------------------------------


@pytest.fixture(scope="module")
def card_lanes():
    """Four ranks on the card in one gloo group, spawned once after the
    kernels are built here (the ranks load them and start no nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels import build

    build.build_all()
    with spmd_qr.make_lane_group(4, device="cuda", timeout_s=300.0) as g:
        yield g


def _ranks_launched(group):
    stepped = ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply")
    for r in group.last_reports:
        assert all(r.launches[op] > 0 for op in stepped), (r.rank, r.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("m_loc,n,events", [
    (6, 10, {sweep_point(1, "tsqr", 0): [2]}),
    (8, 16, {sweep_point(0, "trailing", 0): [1],
             sweep_point(3, "trailing", 1): [1]}),
    (4, 24, {sweep_point(2, "trailing", 1): [2]}),
], ids=["ragged", "aligned-2kills", "wide"])
def test_cuda_spmd_ft_sweep_equals_single_process(rng, cuda, card_lanes,
                                                  m_loc, n, events):
    """The FT sweep with one process per lane at the b = 4 geometries: R,
    factors and bundles bit-equal to the single-process run on the card
    (and so to failure-free), the same ledger, K1-K4 launched by every
    rank."""
    P, b = 4, 4
    A = rng.standard_normal((P * m_loc, n)).astype(np.float32)
    sched = FailureSchedule(events=events)
    got = spmd_qr.ft_caqr_sweep_spmd(A, b, sched, group=card_lanes)
    _ranks_launched(card_lanes)
    At = t(A).reshape(P, m_loc, n).to(cuda)
    sim = ft_caqr_sweep(At, SimComm(P), b, schedule=sched)
    free = caqr_factorize(At, SimComm(P), b, collect_bundles=True,
                          use_scan=False)
    assert _bitwise(got, sim) and _bitwise(got, free)
    assert ([(e.point, e.lane, e.reads) for e in got.events]
            == [(e.point, e.lane, e.reads) for e in sim.events])


@pytest.mark.cuda
def test_cuda_spmd_tall_b128_equals_single_process(rng, cuda, card_lanes):
    """A tall b = 128 case across four ranks: ``caqr_factorize_spmd`` and
    the FT sweep with a trailing kill of the root lane, bit-equal to the
    single-process sweep on the card; K1-K4 launched by every rank."""
    P, m_loc, n, b = 4, 1024, 512, 128
    A = t(rng.standard_normal((P * m_loc, n)).astype(np.float32)).to(cuda)
    At = A.reshape(P, m_loc, n)
    free = caqr_factorize(At, SimComm(P), b, collect_bundles=True,
                          use_scan=False)
    got = spmd_qr.caqr_factorize_lanes(A, b, card_lanes, use_scan=False,
                                       collect_bundles=True)
    _ranks_launched(card_lanes)
    assert _bitwise(got, free)
    sched = FailureSchedule(events={sweep_point(2, "trailing", 1): [0],
                                    sweep_point(3, "leaf"): [3]})
    got = spmd_qr.ft_caqr_sweep_spmd(A, b, sched, group=card_lanes)
    _ranks_launched(card_lanes)
    assert _bitwise(got, free)
    assert [(e.point, e.lane) for e in got.events] == [
        (sweep_point(2, "trailing", 1), 0), (sweep_point(3, "leaf"), 3)]


@pytest.mark.cuda
def test_cuda_spmd_ft_sweep_with_its_own_group(rng, cuda, card_lanes):
    """``ft_caqr_sweep_spmd`` given no group spawns one on the card
    (``pow2_lanes()`` ranks) and closes it before it returns: the result
    is the caller's own, read after the ranks are gone, bit-equal to the
    single-process run on the card and with its ledger."""
    import multiprocessing

    P, m_loc, n, b = spmd_qr.pow2_lanes(), 8, 16, 4
    A = rng.standard_normal((P * m_loc, n)).astype(np.float32)
    sched = FailureSchedule(events={sweep_point(1, "tsqr", 0): [1]})
    before = set(multiprocessing.active_children())
    got = spmd_qr.ft_caqr_sweep_spmd(A, b, sched, device="cuda")
    assert set(multiprocessing.active_children()) <= before
    torch.cuda.ipc_collect()
    sim = ft_caqr_sweep(t(A).reshape(P, m_loc, n).to(cuda), SimComm(P), b,
                        schedule=sched)
    assert _bitwise(got, sim)
    assert ([(e.point, e.lane, e.reads) for e in got.events]
            == [(e.point, e.lane, e.reads) for e in sim.events])


# -- the online and elastic paths over the ranks ------------------------------------


@pytest.fixture(scope="module")
def card_lanes8():
    """Eight ranks on the card in one gloo group (the online entries'
    runner ships each rank only the leaves that changed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from repro_torch.kernels import build

    build.build_all()
    with spmd_qr.make_lane_group(8, device="cuda", timeout_s=300.0) as g:
        yield g


@pytest.mark.cuda
@pytest.mark.parametrize("m_loc,n,b", [(8, 16, 4), (512, 512, 128)],
                         ids=["b4", "b128"])
def test_cuda_spmd_online_and_elastic_equal_single_process(
        rng, cuda, card_lanes8, m_loc, n, b):
    """At 8 ranks on the card: the online sweep with two runtime kills
    (one at a leaf point, one mid-trailing), a kill found a boundary late
    (the killed rank's one-lane K1 runs on NaN first) and the elastic
    SHRINK sweep (one kill, fold 8 -> 4 onto a subgroup) bit-equal to the
    same orchestrator in one process, with its ledger and transitions;
    K1-K4 launched by every rank."""
    P = 8
    A = t(rng.standard_normal((P * m_loc, n)).astype(np.float32)).to(cuda)
    At = A.reshape(P, m_loc, n)
    kills = {sweep_point(1, "leaf"): [5], sweep_point(2, "trailing", 1): [0]}
    got = spmd_qr.ft_caqr_sweep_online_spmd(
        A, b, group=card_lanes8, fault_hooks=[ScriptedKiller(kills)])
    _ranks_launched(card_lanes8)
    one = ft_caqr_sweep_online(At, SimComm(P), b,
                               fault_hooks=[ScriptedKiller(kills)])
    assert _bitwise(got, one)
    assert ([(e.point, e.lane, e.reads) for e in got.events]
            == [(e.point, e.lane, e.reads) for e in one.events])
    assert [e.lane for e in got.events] == [5, 0]

    # found a boundary late: lane 3's rank runs K1 of panel 2 on its NaN
    # slices before the parent heals it
    kill = {sweep_point(1, "trailing", 2): [3]}
    got = spmd_qr.ft_caqr_sweep_online_spmd(
        A, b, group=card_lanes8, fault_hooks=[ScriptedKiller(kill)],
        detector=DelayedDetector(NaNSentinelDetector(), miss=1))
    one = ft_caqr_sweep_online(
        At, SimComm(P), b, fault_hooks=[ScriptedKiller(kill)],
        detector=DelayedDetector(NaNSentinelDetector(), miss=1))
    assert _bitwise(got, one)
    assert [(e.point, e.lane) for e in got.events] == [
        (sweep_point(2, "leaf"), 3)]

    res = spmd_qr.ft_caqr_sweep_elastic_spmd(
        A, b, group=card_lanes8, fault_hooks=[ScriptedKiller(kill)])
    _ranks_launched(card_lanes8)
    one = ft_caqr_sweep_online(At, SimComm(P), b,
                               fault_hooks=[ScriptedKiller(kill)],
                               semantics=Semantics.SHRINK,
                               elastic_policy="fold")
    assert torch.equal(res.R, one.R)
    assert res.transitions == one.transitions and res.world == one.world
    assert res.world.n_slots == 4
    assert card_lanes8.last_steps["worlds"] == [8, 4]


@pytest.mark.cuda
def test_cuda_spmd_online_with_its_own_group(rng, cuda, card_lanes8):
    """``ft_caqr_sweep_online_spmd`` given no group spawns ``pow2_lanes()``
    ranks on the card and closes them before it returns: the result is the
    caller's own, read after the ranks are gone, bit-equal to the
    single-process online run with the same kill."""
    import multiprocessing

    P, m_loc, n, b = spmd_qr.pow2_lanes(), 8, 16, 4
    A = rng.standard_normal((P * m_loc, n)).astype(np.float32)
    kill = {sweep_point(1, "tsqr", 0): [1]}
    before = set(multiprocessing.active_children())
    got = spmd_qr.ft_caqr_sweep_online_spmd(
        A, b, fault_hooks=[ScriptedKiller(kill)], device="cuda")
    assert set(multiprocessing.active_children()) <= before
    torch.cuda.ipc_collect()
    one = ft_caqr_sweep_online(t(A).reshape(P, m_loc, n).to(cuda), SimComm(P),
                               b, fault_hooks=[ScriptedKiller(kill)])
    assert _bitwise(got, one)
    assert ([(e.point, e.lane, e.reads) for e in got.events]
            == [(e.point, e.lane, e.reads) for e in one.events])
