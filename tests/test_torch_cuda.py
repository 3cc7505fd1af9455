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
kernel == the stepped wide route. At bf16 (b <= 128; ``-k bf16``): K1-K4
== the f32 kernel on the widened inputs rounded once, bit for bit, K5 ==
K1 then K2 and ``run_panel_fused`` == ``run_steps`` bit for bit, each
kernel within the bf16 pair of ``ref.tolerances`` of its plain version,
at b <= 128 and above 128 columns (every tile and split of k of the bf16
products held to the order oracle on the widened operands too).
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
    with pytest.raises(NotImplementedError):
        ops.panel_qr(torch.zeros(8, 4, device=cuda, dtype=torch.float16), 0)


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



@pytest.mark.cuda
def test_cuda_engine_equals_cpu(cuda):
    """The token engine (``repro_torch.serve.Engine``) at the gemma2 smoke
    (prompt 24 over a window of 16, so the "L" layers' caches roll) on the
    card against the same engine on the CPU: the prefill's logits and every
    decode step's, fed the CPU's tokens, within (2e-4, 2e-4), and the
    greedy tokens equal wherever the CPU's top-two margin exceeds that."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_smoke("gemma2-2b")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    S0, new = 24, 6
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, S0)).astype(np.int32)
    engines = {dev: Engine(cfg, params, ServeConfig(max_new_tokens=new), device=dev)
               for dev in ("cpu", "cuda")}
    outs = {dev: e.generate(prompts) for dev, e in engines.items()}

    def logits_along(e, toks):
        with torch.no_grad():
            lg, caches = e._prefill(e.params, {"tokens": torch.from_numpy(prompts).to(e.device)})
            caches = e._relayout(caches, S0, S0 + new)
            out = [lg[:, -1]]
            for t in range(new - 1):
                lg, caches = e._step(e.params, torch.from_numpy(toks[:, t:t + 1]).to(e.device),
                                     S0 + t, caches)
                out.append(lg[:, -1])
        return torch.stack(out, dim=1).cpu()

    want = logits_along(engines["cpu"], outs["cpu"])
    got = logits_along(engines["cuda"], outs["cpu"])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    assert torch.equal(want.argmax(-1).to(torch.int32), torch.from_numpy(outs["cpu"]))
    top2 = torch.topk(want, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    for b in range(2):
        for t in range(new):
            if margin[b, t] <= 2e-4:
                break
            assert outs["cuda"][b, t] == outs["cpu"][b, t], (b, t, outs)


def _engine_logits_along(e, prompts, extras, toks, new):
    """The prefill's last logits and each decode step's, fed ``toks``."""
    from repro_torch.models import transformer as tf

    S0 = prompts.shape[1]
    batch = {"tokens": torch.from_numpy(prompts).to(e.device),
             **{k: torch.from_numpy(v).to(e.device) for k, v in extras.items()}}
    with torch.no_grad():
        enc = (() if "enc_frames" not in batch
               else (tf.encode(e.cfg, e.params, batch["enc_frames"]),))
        lg, caches = e._prefill(e.params, batch)
        caches = e._relayout(caches, S0, S0 + new)
        out = [lg[:, -1]]
        for t in range(new - 1):
            lg, caches = e._step(e.params, torch.from_numpy(toks[:, t:t + 1]).to(e.device),
                                 S0 + t, caches, *enc)
            out.append(lg[:, -1])
    return torch.stack(out, dim=1).cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b", "whisper-base",
                                  "pixtral-12b"])
def test_cuda_family_engine_equals_cpu(cuda, arch):
    """The token engine at the mamba2 (SSM states), recurrentgemma (LRU
    states, a rolling local layer), whisper (encoder, cross-attention) and
    pixtral (patch embeddings) smokes on the card against the same engine on
    the CPU, as ``test_cuda_engine_equals_cpu`` holds gemma2's."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_smoke(arch)
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    S0, new = 24, 6
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, S0)).astype(np.int32)
    extras = {}
    if cfg.vlm is not None:
        extras["patch_embeds"] = rng.standard_normal(
            (2, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        extras["enc_frames"] = rng.standard_normal(
            (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    engines = {dev: Engine(cfg, params, ServeConfig(max_new_tokens=new), device=dev)
               for dev in ("cpu", "cuda")}
    outs = {dev: e.generate(prompts, extras or None) for dev, e in engines.items()}
    want = _engine_logits_along(engines["cpu"], prompts, extras, outs["cpu"], new)
    got = _engine_logits_along(engines["cuda"], prompts, extras, outs["cpu"], new)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    assert torch.equal(want.argmax(-1).to(torch.int32), torch.from_numpy(outs["cpu"]))
    top2 = torch.topk(want, 2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).numpy()
    for b in range(2):
        for t in range(new):
            if margin[b, t] <= 2e-4:
                break
            assert outs["cuda"][b, t] == outs["cpu"][b, t], (b, t, outs)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["tri", "scan"])
def test_cuda_chunked_attention_equals_full(rng, cuda, schedule):
    """Streaming attention on the card (S = 2048 in chunks of 512, gemma2's
    softcap, GQA, a window that ends inside a chunk and none) against
    ``full_attention`` on the same card: the output and the gradients of a
    weighted sum with respect to q, k and v, within the f32 tolerance
    scaled by max |full|."""
    from repro_torch.models import attention as attn

    B, S, H, Kv, Dh = 1, 2048, 8, 4, 64
    q, k, v, w = (t(rng.standard_normal(s).astype(np.float32)).to(cuda)
                  for s in ((B, S, H, Dh), (B, S, Kv, Dh), (B, S, Kv, Dh), (B, S, H, Dh)))
    for window in (None, 700):
        outs = []
        for chunked in (True, False):
            x = [a.clone().requires_grad_(True) for a in (q, k, v)]
            if chunked:
                o = attn.chunked_attention(*x, n_kv=Kv, window=window, cap=50.0,
                                           q_chunk=512, kv_chunk=512, schedule=schedule)
            else:
                o = attn.full_attention(*x, n_kv=Kv, window=window, cap=50.0)
            torch.sum(o * w).backward()
            outs.append([o.detach()] + [a.grad for a in x])
        close(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("m,b", [(512, 64), (4096, 128), (512, 256)])
def test_cuda_panel_qr_zero_panel_matches_plain(cuda, m, b):
    """K1 on an all-zero panel (a momentum whose gradient is zero, as
    whisper's encoder weights get without frame embeddings) against its
    plain version, and CAQR-Muon's orthonormalization of a zero momentum:
    [I; 0], as the JAX package gives."""
    from repro_torch.optim.caqr_muon import _orth2d

    A = torch.zeros(4, m, b, device=cuda)
    got, want = tpanel.panel_qr(A, 0), tref.panel_qr(A.cpu(), 0)
    assert all(torch.isfinite(g).all() for g in got)
    close(got, want)
    Q = _orth2d(torch.zeros(m, b, device=cuda))
    eye = torch.zeros(m, b)
    eye[:b] = torch.eye(b)
    assert torch.equal(Q.cpu().abs(), eye)


# Small cells of the autotuner: K2 and K4 up to 128 columns (the tile) and
# above (the products' tile and k range).
TUNE_CELLS = (("wy_apply", (3, 300, 128, 259)), ("wy_apply", (2, 600, 160, 300)),
              ("stacked_apply", (3, 128, 259)), ("stacked_apply", (2, 160, 300)))


@pytest.mark.cuda
@pytest.mark.parametrize("op,geometry", TUNE_CELLS)
def test_cuda_autotune_candidates_keep_bits(cuda, op, geometry):
    """Every candidate of a cell gives the static default's bits (``tune``
    raises otherwise) and the winner is one of the candidates."""
    from repro_torch.kernels import autotune

    autotune.clear()
    try:
        rec = autotune.tune(op, geometry, reps=1)
        assert rec["params"] in autotune.candidates(op, "cuda", geometry)
        assert rec["us"] <= rec["static_us"]
        assert autotune.lookup(op, geometry, torch.float32) == rec["params"]
    finally:
        autotune.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("b,planted", [(128, {"bn": 32}), (160, {"bn": 64, "kbs": 1})])
def test_cuda_autotune_planted_winner_reaches_the_launch(rng, cuda, monkeypatch, b, planted):
    """A winner planted in the tuner's cells is what ``ops.wy_apply``
    passes to the kernel's wrapper (and, above 128, to each product), and
    the result keeps the static tile's bits."""
    from repro_torch.kernels import autotune

    P, m, n = 2, 600, 300
    Y = t(rng.standard_normal((P, m, b)).astype(np.float32) * 0.1).to(cuda)
    T = t(np.triu(rng.standard_normal((P, b, b))).astype(np.float32) * 0.1).to(cuda)
    C = t(rng.standard_normal((P, m, n)).astype(np.float32)).to(cuda)
    seen = []
    real_wy, real_gemm = twy.wy_apply, twide.gemm

    def spy_wy(*a, bn=None, kbs=None):
        seen.append(("wy_apply", bn, kbs))
        return real_wy(*a, bn=bn, kbs=kbs)

    def spy_gemm(*a, **kw):
        seen.append(("gemm", kw.get("bn"), kw.get("kbs")))
        return real_gemm(*a, **kw)

    monkeypatch.setattr(twy, "wy_apply", spy_wy)
    monkeypatch.setattr(twide, "gemm", spy_gemm)
    autotune.clear()
    try:
        static = ops.wy_apply(Y, T, C)
        assert seen[0] == ("wy_apply", None, None)
        seen.clear()
        autotune._CELLS[autotune.cell_key("wy_apply", (P, m, b, n), torch.float32,
                                          "cuda")] = {"params": planted, "us": 1.0}
        tuned = ops.wy_apply(Y, T, C)
        assert seen[0] == ("wy_apply", planted["bn"], planted.get("kbs"))
        if b > twy.MAX_B:
            assert seen[1:] == [("gemm", planted["bn"], planted["kbs"])] * 3
        assert torch.equal(tuned, static)
    finally:
        autotune.clear()


# -- bf16 -------------------------------------------------------------------

BF16 = torch.bfloat16


def held_bf16(got, want, want64):
    """Each bf16 kernel output within the bf16 pair of ``ref.tolerances``
    of the plain version's (``want``, at bf16), as ``atol = 5e-2 * max(1,
    max|plain|)``. The plain version's column loop runs in bf16: where a
    pivot's entry is below bf16's round-off of its column it may pick the
    other reflector (a different valid QR, off by O(1) in Y, T and an R
    row), so an output off its bf16 plain version passes only where that
    plain version is itself off the plain version in float64 on the
    widened inputs (``want64``), and the kernel is within the tolerance of
    the float64 one (as ``chip_smoke.held_bf16``)."""
    rtol, atol = tref.tolerances(BF16)

    def ok(g, w):
        g, w = g.cpu().double(), w.cpu().double()
        bound = atol * max(1.0, float(w.abs().max()) if w.numel() else 1.0)
        return bool(torch.allclose(g, w, rtol=rtol, atol=bound))

    for i, (g, w, w64) in enumerate(zip(got, want, want64)):
        if not ok(g, w):
            assert not ok(w, w64), f"output {i} off its bf16 plain version"
            assert ok(g, w64), f"output {i} off the float64 plain version"


def f64(*xs):
    return tuple(x.double() for x in xs)


def bf16(rng, *shape, scale=1.0, triu=False):
    x = rng.standard_normal(shape) * scale
    return t((np.triu(x) if triu else x).astype(np.float32)).to("cuda", BF16)


def f32_rounded(fn, *xs):
    """The f32 kernel ``fn`` on the widened inputs, each output rounded."""
    out = fn(*(x.float() for x in xs))
    return tuple(o.to(BF16) for o in (out if isinstance(out, tuple) else (out,)))


def same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        g.dtype == w.dtype and torch.equal(g, w) for g, w in zip(got, want))


def err64(got, want64):
    """max |got - want64| / max(1, max |want64|), in float64."""
    g, w = got.double(), want64.double()
    return float((g - w).abs().max()) / max(1.0, float(w.abs().max()))


def wgmma_contract(got, split, witness, want64):
    """The bf16 products of K2 and K4 on wgmma (csrc/wgmma_bf16.cuh): each
    output within one bf16 ulp of the split emulation (``split``: its
    outputs and their term magnitudes, ``ref.bf16_ulp_ok``), and its
    float64 scaled error at most 1.25 x that of the witness (the f32 kernel
    on the widened inputs rounded once, the FFMA body's bits) plus 1e-3."""
    outs, scales = split
    for i, (g, sp, sc, w, w64) in enumerate(zip(got, as_tuple(outs),
                                                as_tuple(scales), witness,
                                                want64)):
        assert g.dtype == BF16
        assert tref.bf16_ulp_ok(g, sp, sc), f"output {i} off the split emulation"
        assert err64(g, w64) <= 1.25 * err64(w, w64) + 1e-3, i


def ints(rng, *shape, triu=False, p=0.5):
    """Entries in {-1, 0, 1} (nonzero with probability p) as bf16: products
    whose every sum is an integer below 2^24 (exact in f32 in any order)."""
    x = rng.choice([-1.0, 1.0], size=shape) * (rng.random(shape) < p)
    return t((np.triu(x) if triu else x).astype(np.float32)).to("cuda", BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,row_start", [(37, 5, 2), (512, 128, 0),
                                           (1000, 96, 37), (4096, 128, 3968)])
def test_cuda_bf16_panel_qr_is_f32_rounded(rng, cuda, m, b, row_start):
    """K1 at bf16: the f32 kernel on the widened panel rounded once, bit for
    bit; within the bf16 tolerance of the plain version (``held_bf16``); a
    lane alone == that lane of a 3-lane launch (the REBUILD replay)."""
    A = bf16(rng, 3, m, b)
    got = ops.panel_qr(A, row_start)
    assert all(x.dtype == BF16 for x in got)
    assert same(got, f32_rounded(lambda x: ops.panel_qr(x, row_start), A))
    held_bf16(got, tref.panel_qr(A, row_start), tref.panel_qr(*f64(A), row_start))
    assert same(tuple(x[1] for x in got), ops.panel_qr(A[1], row_start))


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,n,off", [(37, 5, 13, 4), (256, 128, 300, 4),
                                       (130, 33, 67, 4), (600, 128, 520, 8)])
def test_cuda_bf16_wy_apply_holds_the_wgmma_contract(rng, cuda, m, b, n, off):
    """K2 at bf16 on a strided window (off 4: element-wise staging; off 8:
    16-byte copies), its products on wgmma: the split emulation within one
    bf16 ulp, the witness's float64 error, the plain version's tolerance, a
    lane alone == its lane, every column tile the same bits."""
    Y = bf16(rng, 3, m, b, scale=0.1)
    T = bf16(rng, 3, b, b, scale=0.1, triu=True)
    C = bf16(rng, 3, m, n + off)[..., off:]
    got = ops.wy_apply(Y, T, C)
    assert backend.products_report()["wy_apply"] == backend.ENGINE_WGMMA
    wgmma_contract((got,), tref.wy_apply_split(Y, T, C, scale=True),
                   f32_rounded(ops.wy_apply, Y, T, C), (tref.wy_apply(*f64(Y, T, C)),))
    held_bf16((got,), (tref.wy_apply(Y, T, C),), (tref.wy_apply(*f64(Y, T, C)),))
    assert torch.equal(got[2], ops.wy_apply(Y[2], T[2], C[2]))
    for bn in backend.TILE_BNS:
        assert torch.equal(got, twy.wy_apply(Y, T, C, bn=bn)), bn


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(5, 11), (100, 259), (128, 600)])
def test_cuda_bf16_stacked_qr_is_f32_rounded_and_stacked_apply_on_wgmma(rng, cuda, b, n):
    """K3 at bf16: the f32 kernel rounded once; K4 at bf16 holds the wgmma
    contract (split emulation within one bf16 ulp, the witness's float64
    error), every column tile the same bits; the plain versions'
    tolerance; a lane alone == its lane; K3 gives both lanes of a butterfly
    pair, which stack the same triangles, the same bits."""
    P = 4
    Rt = t(np.stack([qr_factor(rng, b) for _ in range(P)])).to(cuda, BF16)
    Rb = t(np.stack([qr_factor(rng, b) for _ in range(P)])).to(cuda, BF16)
    got = ops.stacked_qr(Rt, Rb)
    assert same(got, f32_rounded(ops.stacked_qr, Rt, Rb))
    held_bf16(got, tref.stacked_qr(Rt, Rb), tref.stacked_qr(*f64(Rt, Rb)))
    assert same(tuple(x[3] for x in got), ops.stacked_qr(Rt[3], Rb[3]))
    pair = ops.stacked_qr(Rt[[0, 0]].contiguous(), Rb[[0, 0]].contiguous())
    assert all(torch.equal(x[0], x[1]) for x in pair)
    Y2, T = got[0], got[1]
    Ct, Cb = bf16(rng, P, b, n), bf16(rng, P, b, n)
    out = ops.stacked_apply(Y2, T, Ct, Cb)
    assert backend.products_report()["stacked_apply"] == backend.ENGINE_WGMMA
    wgmma_contract(out, tref.stacked_apply_split(Y2, T, Ct, Cb, scale=True),
                   f32_rounded(ops.stacked_apply, Y2, T, Ct, Cb),
                   tref.stacked_apply(*f64(Y2, T, Ct, Cb)))
    held_bf16(out, tref.stacked_apply(Y2, T, Ct, Cb),
              tref.stacked_apply(*f64(Y2, T, Ct, Cb)))
    assert same(tuple(x[1] for x in out), ops.stacked_apply(Y2[1], T[1], Ct[1], Cb[1]))
    for bn in backend.TILE_BNS:
        assert same(out, tstacked.stacked_apply(Y2, T, Ct, Cb, bn=bn)), bn


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,b,row_start", [(37, 45, 5, 2), (64, 200, 8, 60),
                                             (512, 300, 128, 0),
                                             (4096, 640, 128, 7)])
def test_cuda_bf16_panel_qr_apply_equals_k1_k2(rng, cuda, m, w, b, row_start):
    """K5 at bf16 == K1 then K2 at bf16 bit for bit (the stepped route
    rounds Y and T before the apply, and so does K5), within the bf16
    tolerance of its plain version, a lane alone == its lane."""
    W = bf16(rng, 3, m, w + 3)[..., 3:]
    got = ops.panel_qr_apply(W, row_start, b)
    Y, T, R = ops.panel_qr(W[..., :b], row_start)
    C = ops.wy_apply(Y, T, W)
    r0 = min(max(row_start, 0), m - b)
    assert same(got, (Y, T, R, C, C[:, r0:r0 + b].contiguous()))
    held_bf16(got, tref.panel_qr_apply(W, row_start, b),
              tref.panel_qr_apply(W.double(), row_start, b))
    assert same(tuple(x[2] for x in got), ops.panel_qr_apply(W[2], row_start, b))


@pytest.mark.cuda
@pytest.mark.parametrize("P,m_loc,w,b,k", [(2, 16, 21, 5, 0), (4, 24, 50, 8, 4),
                                           (8, 32, 70, 8, 9)])
def test_cuda_bf16_fused_panel_matches_plain(rng, cuda, P, m_loc, w, b, k):
    """K6 at bf16 within the bf16 tolerance of fused_panel_math over the
    plain forms, every output bf16."""
    L = P.bit_length() - 1
    win = bf16(rng, P, m_loc, w)
    got = ops.fused_panel(win, k, b=b, m_loc_pad=m_loc, levels=L)
    want = tref.fused_panel(win, k, b=b, m_loc_pad=m_loc, levels=L)
    want64 = tref.fused_panel(win.double(), k, b=b, m_loc_pad=m_loc, levels=L)
    fields = [f for f in want if f != "tops"]
    assert all(got[f].dtype == BF16 for f in fields)
    held_bf16(tuple(got[f] for f in fields), tuple(want[f] for f in fields),
              tuple(want64[f] for f in fields))


@pytest.mark.cuda
@pytest.mark.parametrize("P,m_loc,n,b", [(4, 8, 16, 4), (8, 32, 256, 16),
                                         (4, 512, 1024, 128)])
def test_cuda_bf16_fused_equals_stepped_bitwise(rng, cuda, P, m_loc, n, b):
    """run_panel_fused (K6 at bf16) == run_steps (K1-K4 at bf16), bit for
    bit at every panel boundary and after finalize."""
    comm = SimComm(P)
    A = bf16(rng, P, m_loc, n)
    s_f = s_s = tstate.initial_sweep_state(comm, A, b)
    pts = tstate.panel_points(s_s.geom)
    backend.reset_launches()
    while s_f.cursor is not None:
        s_f = tstate.run_panel_fused(comm, s_f)
        s_s = tstate.run_steps(comm, s_s, pts)
        _assert_states_equal(s_f, s_s, s_s.cursor)
    assert backend.BF16_LAUNCHES["fused_panel"] == s_s.geom.n_panels
    assert all(backend.BF16_LAUNCHES[op] > 0 for op in
               ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply"))
    for g, w in zip(tstate.finalize(comm, s_f), tstate.finalize(comm, s_s)):
        got = [g] if isinstance(g, torch.Tensor) else list(g)
        want = [w] if isinstance(w, torch.Tensor) else list(w)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_cuda_bf16_sweep_and_kill_bitwise(rng, cuda):
    """The bf16 sweep launches K1-K4 at bf16, R replicated bitwise and its
    float64 Gram residual under 0.1; a killed lane rebuilt gives R,
    factors and bundles bit-equal to the failure-free bf16 sweep."""
    P, m_loc, n, b = 8, 32, 128, 8
    comm = SimComm(P)
    A = bf16(rng, P, m_loc, n)
    backend.reset_launches()
    res = caqr_factorize(A, comm, b, collect_bundles=True, use_scan=False)
    assert all(backend.BF16_LAUNCHES[op] > 0 for op in
               ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply"))
    assert res.R.dtype == BF16 and bool((res.R == res.R[:1]).all())
    A64 = A.reshape(-1, n).double()
    G = A64.T @ A64
    R64 = res.R[0].double()
    assert float((R64.T @ R64 - G).abs().max() / G.abs().max()) <= 0.1
    point = sweep_point(6, "trailing", 2)
    got = ft_caqr_sweep(A, comm, b, schedule=FailureSchedule(events={point: [5]}))
    assert _bitwise(got, res)
    (event,) = got.events
    assert event.point == point and event.lane == 5


@pytest.mark.cuda
def test_cuda_bf16_full_width_equals_windowed(rng, cuda):
    """caqr_factorize's full-width form (use_scan=True) on a bf16 matrix
    launches the bf16 kernels and gives the windowed form's R and factors
    bit for bit, as at f32 (tests/test_torch_core.py)."""
    P, m_loc, n, b = 8, 32, 128, 8
    A = bf16(rng, P, m_loc, n)
    w = caqr_factorize(A, SimComm(P), b, use_scan=False)
    backend.reset_launches()
    f = caqr_factorize(A, SimComm(P), b, use_scan=True)
    assert all(backend.BF16_LAUNCHES[op] > 0 for op in
               ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply"))
    assert f.R.dtype == BF16 and torch.equal(w.R, f.R)
    assert all(torch.equal(x, y) for x, y in zip(w.factors, f.factors))


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["panel_qr", "wy_apply", "stacked_qr",
                                "stacked_apply", "panel_qr_apply", "fused_panel"])
def test_cuda_bf16_above_128_columns_runs_the_bf16_kernels(rng, cuda, op):
    """bf16 above 128 columns runs each op's hand-written bf16 kernel: one
    bf16 launch of the op, its engine the CUDA kernel, the outputs bf16;
    K1 and K3 the f32 kernel's on the widened inputs rounded once, K2 and
    K4 the wgmma contract (their products on the tensor cores), K5 K1 then
    K2, K6's leaf factors and applied window K1's and K2's, bit for bit
    (it raised while only b <= 128 had bf16 kernels)."""
    b, m, n = 160, 512, 320
    W = bf16(rng, 2, m, n)
    sq = bf16(rng, 2, b, b, scale=0.1, triu=True)
    Ct, Cb = W[:, :b, :b].contiguous(), W[:, b:2 * b, :b].contiguous()
    calls = {
        "panel_qr": lambda x, s: ops.panel_qr(x[..., :b], 0),
        "wy_apply": lambda x, s: ops.wy_apply(x[..., :b].contiguous(), s, x),
        "stacked_qr": lambda x, s: ops.stacked_qr(s, s),
        "stacked_apply": lambda x, s: ops.stacked_apply(s, s, Ct.to(x.dtype),
                                                        Cb.to(x.dtype)),
        "panel_qr_apply": lambda x, s: ops.panel_qr_apply(x, 0, b),
        "fused_panel": lambda x, s: ops.fused_panel(x, 0, b=b, m_loc_pad=m,
                                                    levels=1),
    }
    backend.reset_launches()
    got = calls[op](W, sq)
    assert backend.LAUNCHES[op] == backend.BF16_LAUNCHES[op] == 1
    assert backend.probe_report()[op]["engine"] == backend.ENGINE_CUDA
    outs = tuple(got[f] for f in tfused.FUSED_FIELDS) if op == "fused_panel" \
        else (got if isinstance(got, tuple) else (got,))
    assert all(x.dtype == BF16 for x in outs)
    if op in ("panel_qr", "stacked_qr"):
        assert same(got, f32_rounded(lambda x, s: calls[op](x, s), W, sq))
    elif op in ("wy_apply", "stacked_apply"):
        assert backend.products_report()[op] == backend.ENGINE_WGMMA
        args = ((W[..., :b].contiguous(), sq, W) if op == "wy_apply"
                else (sq, sq, Ct, Cb))
        split = (tref.wy_apply_split if op == "wy_apply" else tref.stacked_apply_split)
        plain = tref.wy_apply if op == "wy_apply" else tref.stacked_apply
        wgmma_contract(as_tuple(got), split(*args, scale=True),
                       f32_rounded(lambda x, s: calls[op](x, s), W, sq),
                       as_tuple(plain(*f64(*args))))
    else:
        Y, T, R = ops.panel_qr(W[..., :b], 0)
        C = ops.wy_apply(Y, T, W)
        if op == "panel_qr_apply":
            assert same(got, (Y, T, R, C, C[:, :b].contiguous()))
        else:
            assert torch.equal(got["leaf_Y"], Y) and torch.equal(got["C_local"], C)


# -- bf16 above 128 columns -----------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,row_start", [(1024, 256, 0), (1000, 200, 37),
                                           (1000, 200, 800), (512, 300, 0)])
def test_cuda_bf16_wide_panel_qr_is_f32_rounded(rng, cuda, m, b, row_start):
    """K1 above 128 columns at bf16 (one launch of csrc/
    panel_qr_wide_bf16.cu): the f32 wide launch on the widened panel rounded
    once, bit for bit, at a ragged width too; within the bf16 tolerance of
    the plain version (``held_bf16``); a lane alone == that lane of a
    3-lane launch (the REBUILD replay)."""
    A = bf16(rng, 3, m, b + 5)[..., 5:]
    got = ops.panel_qr(A, row_start)
    assert all(x.dtype == BF16 for x in got)
    assert same(got, f32_rounded(lambda x: ops.panel_qr(x, row_start), A))
    held_bf16(got, tref.panel_qr(A, row_start), tref.panel_qr(*f64(A), row_start))
    assert same(tuple(x[1] for x in got), ops.panel_qr(A[1], row_start))


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,n,off", [(512, 256, 300, 4), (600, 200, 130, 4),
                                       (1024, 256, 512, 8)])
def test_cuda_bf16_wide_wy_apply_holds_the_wgmma_contract(rng, cuda, m, b, n, off):
    """K2 above 128 columns at bf16 on a strided window (off 4:
    element-wise staging; off 8: 16-byte copies), its three products on
    wgmma (Y^T C and W stay f32): the split emulation within one bf16 ulp,
    the witness's float64 error, the plain version's tolerance, a lane
    alone == its lane, every column tile and split of k the same bits."""
    Y = bf16(rng, 3, m, b, scale=0.1)
    T = bf16(rng, 3, b, b, scale=0.1, triu=True)
    C = bf16(rng, 3, m, n + off)[..., off:]
    got = ops.wy_apply(Y, T, C)
    assert backend.products_report()["wy_apply"] == backend.ENGINE_WGMMA
    wgmma_contract((got,), tref.wy_apply_split(Y, T, C, scale=True),
                   f32_rounded(ops.wy_apply, Y, T, C), (tref.wy_apply(*f64(Y, T, C)),))
    held_bf16((got,), (tref.wy_apply(Y, T, C),), (tref.wy_apply(*f64(Y, T, C)),))
    assert torch.equal(got[2], ops.wy_apply(Y[2], T[2], C[2]))
    for bn in backend.TILE_BNS:
        assert torch.equal(got, twy.wy_apply(Y, T, C, bn=bn, kbs=1)), bn


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(200, 259), (256, 600)])
def test_cuda_bf16_wide_stacked_qr_is_f32_rounded_and_stacked_apply_on_wgmma(rng, cuda, b, n):
    """K3 above 128 columns at bf16: the f32 route on the widened inputs
    rounded once; K4 the wgmma contract (its W rounded after C_bot - Y2 W
    read it in f32), every column tile the same bits; the plain versions'
    tolerance; a lane alone == its lane; both lanes of a butterfly pair the
    same bits."""
    P = 4
    Rt = t(np.stack([qr_factor(rng, b) for _ in range(P)])).to(cuda, BF16)
    Rb = t(np.stack([qr_factor(rng, b) for _ in range(P)])).to(cuda, BF16)
    got = ops.stacked_qr(Rt, Rb)
    assert all(x.dtype == BF16 for x in got)
    assert same(got, f32_rounded(ops.stacked_qr, Rt, Rb))
    held_bf16(got, tref.stacked_qr(Rt, Rb), tref.stacked_qr(*f64(Rt, Rb)))
    assert same(tuple(x[3] for x in got), ops.stacked_qr(Rt[3], Rb[3]))
    pair = ops.stacked_qr(Rt[[0, 0]].contiguous(), Rb[[0, 0]].contiguous())
    assert all(torch.equal(x[0], x[1]) for x in pair)
    Y2, T = got[0], got[1]
    Ct, Cb = bf16(rng, P, b, n), bf16(rng, P, b, n)
    out = ops.stacked_apply(Y2, T, Ct, Cb)
    assert backend.products_report()["stacked_apply"] == backend.ENGINE_WGMMA
    wgmma_contract(out, tref.stacked_apply_split(Y2, T, Ct, Cb, scale=True),
                   f32_rounded(ops.stacked_apply, Y2, T, Ct, Cb),
                   tref.stacked_apply(*f64(Y2, T, Ct, Cb)))
    held_bf16(out, tref.stacked_apply(Y2, T, Ct, Cb),
              tref.stacked_apply(*f64(Y2, T, Ct, Cb)))
    assert same(tuple(x[1] for x in out), ops.stacked_apply(Y2[1], T[1], Ct[1], Cb[1]))
    for bn in backend.TILE_BNS:
        assert same(out, tstacked.stacked_apply(Y2, T, Ct, Cb, bn=bn, kbs=1)), bn


# The bf16 products of the wide routes (P, M, N, K, kind): "BBF" a bf16 A
# and B into float (D bf16 or none), "BFF" a bf16 A times a float B into
# float (with the second store E - AB in bf16, or none), "BFB" a bf16 A
# times a float B from a bf16 D into bf16.
BF16_GEMM_CASES = [(8, 256, 300, 5632, "BBF At"), (2, 97, 65, 600, "BBF D"),
                   (1, 200, 129, 300, "BFF At"), (3, 70, 260, 513, "BFF E"),
                   (2, 1000, 257, 256, "BFB"), (1, 130, 70, 17, "BFB sub")]


def _bf16_gemm_operands(case, cuda, integers=False):
    """A bf16 product's operands from a BF16_GEMM_CASES entry: (A, B, D, E,
    sub, out_dtype); ``integers``: entries in {-1, 0, 1}."""
    P, M, N, K, how = case
    g = torch.Generator().manual_seed(sum(case[:4]))
    kind = how.split()[0]
    A, B, D, E = _gemm_case(g, P, M, N, K, ("" if "D" in how or kind == "BFB"
                                            else "noD ") + how, cuda)
    if integers:
        A, B, D, E = (None if x is None else x.sign() * (x.abs() > 0.7)
                      for x in (A, B, D, E))
    A = A.to(BF16)
    B = B.to(BF16) if kind == "BBF" else B
    D = None if D is None else D.to(BF16)
    E = E.to(BF16) if "E" in how else None
    sub = "sub" in how or kind == "BFB"
    return A, B, D, E, sub, BF16 if kind == "BFB" else torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_GEMM_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_bf16_wide_gemm_is_its_split_emulation_at_every_tile(cuda, case):
    """wide_gemm at the bf16 mixes, on wgmma: within one bf16 ulp of the
    split emulation (``wide.gemm_split``) where it stores bf16 and within
    f32 round-off where it stores f32; every tile (bn 32/64/128, a wgmma N
    of 16 to 128) and split of k gives the same bits."""
    A, B, D, E, sub, out_dtype = _bf16_gemm_operands(case, cuda)
    want, scales = twide.gemm_split(A, B, D, sub=sub, minuend=E,
                                    out_dtype=out_dtype, scale=True)
    ref_bits = as_tuple(twide.gemm(A, B, D, sub=sub, minuend=E,
                                   out_dtype=out_dtype))
    for g, w, sc in zip(ref_bits, want, scales):
        assert g.dtype == w.dtype
        if g.dtype == BF16:
            assert tref.bf16_ulp_ok(g, w, sc)
        else:
            scale = max(1.0, float(w.abs().max()))
            assert float((g - w).abs().max()) <= 2.0 ** -16 * scale
    nblk = twide.kblocks(case[3])
    for bn in twide.TILES:
        for kbs in sorted({None, nblk, 1, 2}, key=str):
            got = as_tuple(twide.gemm(A, B, D, sub=sub, minuend=E, bn=bn,
                                      kbs=kbs, out_dtype=out_dtype))
            assert same(got, ref_bits), (bn, kbs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BF16_GEMM_CASES, ids=lambda c: "-".join(map(str, c)))
def test_cuda_bf16_wgmma_routine_exact_on_integers_and_lane_alone(cuda, case):
    """The wgmma routine alone on operands in {-1, 0, 1}, whose every sum
    is exact in f32 (and every f32 B splits exactly): the split emulation
    bit for bit at every tile and split of k, so each layout, major order,
    wgmma N and copy path puts every term in its place; and, on random
    operands, each lane alone == that lane of the P-lane launch."""
    A, B, D, E, sub, out_dtype = _bf16_gemm_operands(case, cuda, integers=True)
    want = as_tuple(twide.gemm_split(A, B, D, sub=sub, minuend=E,
                                     out_dtype=out_dtype))
    nblk = twide.kblocks(case[3])
    for bn in twide.TILES:
        for kbs in sorted({None, 1}, key=str):
            got = as_tuple(twide.gemm(A, B, D, sub=sub, minuend=E, bn=bn,
                                      kbs=kbs, out_dtype=out_dtype))
            assert same(got, want), (bn, kbs, nblk)
    A, B, D, E, sub, out_dtype = _bf16_gemm_operands(case, cuda)
    full = as_tuple(twide.gemm(A, B, D, sub=sub, minuend=E, out_dtype=out_dtype))
    p = case[0] - 1
    one = as_tuple(twide.gemm(A[p:p + 1], B[p:p + 1],
                              None if D is None else D[p:p + 1], sub=sub,
                              minuend=None if E is None else E[p:p + 1],
                              out_dtype=out_dtype))
    assert same(tuple(x[p:p + 1] for x in full), one)


@pytest.mark.cuda
@pytest.mark.parametrize("m,b,n,off", [(256, 128, 200, 8), (130, 33, 67, 4),
                                       (300, 160, 200, 8)])
def test_cuda_bf16_wgmma_k2_k4_exact_on_integers(cuda, m, b, n, off):
    """K2 and K4 at bf16 (b <= 128: the engine, every column tile; above:
    the wide route) on entries in {-1, 0, 1}, where every sum of the chain
    is an integer below 2^24 and every split exact: equal to the split
    emulation bit for bit, so the engine's three phases put every term in
    its place."""
    rng = np.random.default_rng(m + b + n)
    Y = ints(rng, 2, m, b, p=0.5)
    T = ints(rng, 2, b, b, triu=True, p=0.5)
    C = ints(rng, 2, m, n + off, p=0.5)[..., off:]
    Ct, Cb = ints(rng, 2, b, n), ints(rng, 2, b, n)
    Y2 = ints(rng, 2, b, b, triu=True, p=0.5)
    W = tref.stacked_apply_split(Y2, T, Ct, Cb)[2]
    assert float(W.float().abs().max()) < 2 ** 16  # the split is exact
    bns = backend.TILE_BNS if b <= twy.MAX_B else (None,)
    for bn in bns:
        assert torch.equal(twy.wy_apply(Y, T, C, bn=bn), tref.wy_apply_split(Y, T, C)), bn
        assert same(tstacked.stacked_apply(Y2, T, Ct, Cb, bn=bn),
                    tref.stacked_apply_split(Y2, T, Ct, Cb)), bn


@pytest.mark.cuda
def test_cuda_bf16_wide_gemm_rejects_other_mixes(cuda):
    """A mix of element types no bf16 route runs raises before a launch."""
    A = torch.zeros(1, 8, 8, device=cuda, dtype=BF16)
    F = torch.zeros(1, 8, 8, device=cuda)
    with pytest.raises(NotImplementedError, match="element types"):
        twide.gemm(F, A)
    with pytest.raises(NotImplementedError, match="element types"):
        twide.gemm(A, A)  # a bf16 out from bf16 A and B: no route
    with pytest.raises(ValueError, match="float32 operands only"):
        twide.gemm_order(A, F)


@pytest.mark.cuda
@pytest.mark.parametrize("m,w,b,row_start", [(1024, 600, 256, 0),
                                             (1000, 450, 200, 37)])
def test_cuda_bf16_wide_k5_equals_k1_k2(rng, cuda, m, w, b, row_start):
    """K5 above 128 columns at bf16 == K1 then K2 at bf16 bit for bit (both
    round Y and T before the apply), within the bf16 tolerance of its plain
    version, a lane alone == its lane of an eight-lane launch."""
    W = bf16(rng, 8, m, w + 3)[..., 3:]
    rs = torch.tensor([row_start, 0, m - b] + [row_start] * 5, dtype=torch.int32)
    got = ops.panel_qr_apply(W, rs, b)
    Y, T, R = ops.panel_qr(W[..., :b], rs)
    C = ops.wy_apply(Y, T, W)
    r0 = rs.long().clamp(0, m - b)
    Cp = torch.stack([C[p, r0[p]:r0[p] + b] for p in range(8)])
    assert same(got, (Y, T, R, C, Cp))
    held_bf16(got, tref.panel_qr_apply(W, rs, b),
              tref.panel_qr_apply(W.double(), rs, b))
    assert same(tuple(x[3] for x in got), ops.panel_qr_apply(W[3], row_start, b))


@pytest.mark.cuda
@pytest.mark.parametrize("P,m_loc,n", [(2, 512, 1024), (8, 512, 1024)])
def test_cuda_bf16_wide_fused_equals_stepped_bitwise(rng, cuda, P, m_loc, n):
    """run_panel_fused (K6 above 128 columns at bf16) == run_steps (K1-K4
    above 128 at bf16), bit for bit at every panel boundary and after
    finalize, at b = 256 through consumed lanes and dead groups."""
    b = 256
    comm = SimComm(P)
    A = bf16(rng, P, m_loc, n)
    s_f = s_s = tstate.initial_sweep_state(comm, A, b)
    pts = tstate.panel_points(s_s.geom)
    backend.reset_launches()
    while s_f.cursor is not None:
        s_f = tstate.run_panel_fused(comm, s_f)
        s_s = tstate.run_steps(comm, s_s, pts)
        _assert_states_equal(s_f, s_s, s_s.cursor)
    assert backend.BF16_LAUNCHES["fused_panel"] == s_s.geom.n_panels
    assert all(backend.BF16_LAUNCHES[op] > 0 for op in
               ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply"))
    for g, w in zip(tstate.finalize(comm, s_f), tstate.finalize(comm, s_s)):
        got = [g] if isinstance(g, torch.Tensor) else list(g)
        want = [w] if isinstance(w, torch.Tensor) else list(w)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_cuda_bf16_wide_sweep_and_kill_bitwise(rng, cuda):
    """The bf16 sweep at b = 256 launches K1-K4's bf16 kernels, R replicated
    bitwise and its float64 Gram residual under 0.1; a killed lane rebuilt
    gives R, factors and bundles bit-equal to the failure-free sweep; one
    lane == eight lanes for K1, K2 and K4."""
    P, m_loc, n, b = 8, 512, 1024, 256
    comm = SimComm(P)
    A = bf16(rng, P, m_loc, n)
    backend.reset_launches()
    res = caqr_factorize(A, comm, b, collect_bundles=True, use_scan=False)
    assert all(backend.BF16_LAUNCHES[op] > 0 for op in
               ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply"))
    assert backend.SUB_LAUNCHES["wide_round_bf16"] > 0
    assert res.R.dtype == BF16 and bool((res.R == res.R[:1]).all())
    A64 = A.reshape(-1, n).double()
    G = A64.T @ A64
    R64 = res.R[0].double()
    assert float((R64.T @ R64 - G).abs().max() / G.abs().max()) <= 0.1
    point = sweep_point(2, "trailing", 1)
    got = ft_caqr_sweep(A, comm, b, schedule=FailureSchedule(events={point: [5]}))
    assert _bitwise(got, res)
    (event,) = got.events
    assert event.point == point and event.lane == 5
    Y, T, R = ops.panel_qr(A[..., :b], 0)
    C = ops.wy_apply(Y, T, A)
    Ct, Cb = C[:, :b].contiguous(), C[[p ^ 1 for p in range(P)], :b].contiguous()
    Y2, T2, _ = ops.stacked_qr(R, R[[p ^ 1 for p in range(P)]].contiguous())
    k4 = ops.stacked_apply(Y2, T2, Ct, Cb)
    for k in (0, 5):
        assert same(tuple(x[k] for x in (Y, T, R)), ops.panel_qr(A[k, :, :b], 0))
        assert torch.equal(C[k], ops.wy_apply(Y[k], T[k], A[k]))
        assert same(tuple(x[k] for x in k4),
                    ops.stacked_apply(Y2[k], T2[k], Ct[k], Cb[k]))


@pytest.mark.cuda
@pytest.mark.parametrize("op,geometry", [("wy_apply", (2, 600, 160, 300)),
                                         ("stacked_apply", (2, 160, 300))])
def test_cuda_autotune_bf16_candidates_keep_bits(cuda, op, geometry):
    """The autotuner's bf16 cells above 128 columns: every candidate (the
    products' tile and k range) gives the static default's bits."""
    from repro_torch.kernels import autotune

    autotune.clear()
    try:
        rec = autotune.tune(op, geometry, dtype=BF16, reps=1)
        assert rec["params"] in autotune.candidates(op, "cuda", geometry)
        assert autotune.lookup(op, geometry, BF16) == rec["params"]
    finally:
        autotune.clear()


@pytest.mark.cuda
def test_cuda_bf16_mixed_dtypes_raise(rng, cuda):
    Y = bf16(rng, 2, 64, 8, scale=0.1)
    T = bf16(rng, 2, 8, 8, triu=True)
    C = bf16(rng, 2, 64, 16)
    with pytest.raises(ValueError, match="one dtype"):
        ops.wy_apply(Y, T.float(), C)
    with pytest.raises(ValueError, match="one dtype"):
        ops.stacked_apply(T, T, C[:, :8].float(), C[:, :8].float())
