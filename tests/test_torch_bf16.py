"""The port at bf16 against the JAX package at bf16.

On this CPU the port's ops run their plain PyTorch versions, bf16
throughout like the JAX package's pure forms; on the card the bf16 kernels
K1-K6 (at any panel width) are held to the f32 kernels rounded once and to
these plain versions by ``tests/test_torch_cuda.py -k bf16``. Panel widths
above 128 (the port's blocked routes on the card) have a geometry of their
own here (``WIDE``). Inputs are made
with numpy from a seed, rounded to bf16 once, and fed to both packages.
Floats are compared at the JAX package's bf16 tolerance,
``atol = 5e-2 * max(1, max|ref|)`` (``ref.tolerances``); ledgers, the
geometry and ``tops`` exactly; the port's own bitwise claims (kill ==
failure-free, fused == stepped) bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import repro.core as J
import repro.ft as jft
from repro.kernels import fused_sweep as jfused
from repro.kernels import panel_qr as jpanel
from repro.kernels import ref as jref
from repro.kernels import stacked_qr as jstacked
from repro.kernels import wy_apply as jwy
import repro_torch.core as T
from repro_torch.ft import FailureSchedule, ft_caqr_sweep, sweep_point
from repro_torch.ft.online import state as tstate
from repro_torch.kernels import backend, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wide as twide

RTOL, ATOL = jref.tolerances(jnp.bfloat16)
BF16 = torch.bfloat16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this module: under xdist six workers' thread
    teams would spin against each other (``tests/test_torch_moe.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want):
    """Each output of the port within the bf16 tolerance of the JAX
    package's, scaled by max(1, max|ref|)."""
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(
            g.double().numpy(), w, rtol=RTOL,
            atol=ATOL * max(1.0, np.abs(w).max(initial=0)))


def both(x):
    """One numpy array as (torch bf16, jax bf16): the same bf16 values."""
    x = np.ascontiguousarray(x, np.float32)
    return torch.from_numpy(x).to(BF16), jnp.asarray(x, jnp.bfloat16)


def qr_factor(rng, b):
    """A well-conditioned upper-triangular b x b R factor."""
    return np.linalg.qr(rng.standard_normal((2 * b, b)))[1].astype(np.float32)


# -- the dtype rule -----------------------------------------------------------


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "f32"),
                                          (torch.bfloat16, "bf16"),
                                          (torch.float16, None),
                                          (torch.float64, None)])
def test_kernel_suffix_rule(dtype, suffix):
    """f32 and bf16 map to their C entry points' suffix; float16 and
    float64 have no kernel and raise."""
    if suffix is None:
        with pytest.raises(NotImplementedError):
            backend.kernel_suffix(dtype)
    else:
        assert backend.kernel_suffix(dtype) == suffix
        assert backend.kernel_dtype("op", torch.zeros(2, dtype=dtype)) == suffix


def test_mixed_dtypes_and_wide_bf16_raise():
    """Mixed dtypes raise ValueError; float16 raises NotImplementedError at
    b = 256 as at any width; f32 and bf16 both have kernels at b = 256 (the
    width gate of the b <= 128 bf16 kernels is gone)."""
    with pytest.raises(ValueError, match="one dtype"):
        backend.kernel_dtype("wy_apply", torch.zeros(2), torch.zeros(2, dtype=BF16))
    wide16 = torch.zeros(2, 512, 256, dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="float16"):
        backend.kernel_dtype("panel_qr", wide16)
    for dtype in (torch.float32, BF16):
        assert backend.kernel_dtype("panel_qr", torch.zeros(2, 512, 256, dtype=dtype))
    assert not hasattr(backend, "check_width") and not hasattr(backend, "BF16_MAX_B")


# -- K1-K5 on the shapes of the reference's bf16 parity matrix ----------------

SHAPES = [(30, 12, 17), (9, 5, 11), (37, 12, 25)]


def _inputs(op, m, b, n, seed):
    """The op's inputs as numpy, as ``tests/test_kernels.py::
    test_parity_matrix_ragged`` draws them (stacked inputs from QR
    factors)."""
    rng = np.random.default_rng(seed)
    if op == "panel_qr":
        return (rng.standard_normal((m, b)),)
    if op == "stacked_qr":
        return qr_factor(rng, b), qr_factor(rng, b)
    if op == "wy_apply":
        return (rng.standard_normal((m, b)) * 0.1,
                np.triu(rng.standard_normal((b, b))) * 0.1,
                rng.standard_normal((m, n)))
    if op == "stacked_apply":
        Tm = np.triu(rng.standard_normal((b, b))) * 0.1
        return Tm, Tm, rng.standard_normal((b, n)), rng.standard_normal((b, n))
    return (rng.standard_normal((m, b + 7)),)  # panel_qr_apply


def _jax_op(op, args, b):
    """The JAX package's Pallas kernel of ``op`` in interpret mode."""
    if op == "panel_qr":
        return jpanel.panel_qr(*args, 0, interpret=True)
    if op == "stacked_qr":
        return jstacked.stacked_qr(*args, interpret=True)
    if op == "wy_apply":
        return jwy.wy_apply(*args, interpret=True)
    if op == "stacked_apply":
        return jstacked.stacked_apply(*args, interpret=True)
    return jfused.panel_qr_apply(*args, jnp.int32(0), b, interpret=True)


def _port_op(op, args, b):
    if op == "panel_qr":
        return ops.panel_qr(*args, 0)
    if op == "panel_qr_apply":
        return ops.panel_qr_apply(*args, 0, b)
    return getattr(ops, op)(*args)


@pytest.mark.parametrize("m,b,n", SHAPES)
@pytest.mark.parametrize("op", ["panel_qr", "stacked_qr", "wy_apply",
                                "stacked_apply", "panel_qr_apply"])
def test_k1_k5_bf16_match_pallas_interpret(op, m, b, n):
    """K1-K5 at bf16: the port's ops (plain versions here) against the JAX
    package's Pallas kernels in interpret mode, every output bf16."""
    pairs = [both(x) for x in _inputs(op, m, b, n, seed=m * 100 + b)]
    got = _port_op(op, [p[0] for p in pairs], b)
    want = _jax_op(op, [p[1] for p in pairs], b)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert all(g.dtype == BF16 for g in got)
    assert all(w.dtype == jnp.bfloat16 for w in want)
    close(got, want)


# -- the split of the bf16 products (csrc/wgmma_bf16.cuh) --------------------

# The JAX package's K2 and K4 tile programs, jitted once.
_JAX_MATH = {"wy_apply": jax.jit(jwy.wy_apply_math),
             "stacked_apply": jax.jit(jstacked.stacked_apply_math)}
_SPLIT = {"wy_apply": tref.wy_apply_split, "stacked_apply": tref.stacked_apply_split}


def test_split_bf16_is_the_kernels_rule():
    """ref.split_bf16: hi is x rounded to nearest even bf16 and hi + lo
    reproduces x to 2^-16 relative (exactly where x has at most 16
    significant bits), across a wide range of magnitudes."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((64, 48)) * np.exp2(rng.integers(-20, 20, (64, 48))))
    x = torch.from_numpy(x.astype(np.float32))
    hi, lo = tref.split_bf16(x)
    assert hi.dtype == lo.dtype == BF16
    assert torch.equal(hi, x.to(BF16))
    rel = (hi.double() + lo.double() - x.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0 ** -16
    ints = torch.arange(-65535, 65536, 251, dtype=torch.float32)
    h, l = tref.split_bf16(ints)
    assert torch.equal(h.float() + l.float(), ints)


def test_split_matmul_carries_f32_operand():
    """ref.split_matmul (a bf16 A times an f32 X as two bf16 products) is
    within 2^-15 of the f32 product, scaled by |A| |X|, where the bf16
    product of the rounded X is off by about 2^-9."""
    rng = np.random.default_rng(12)
    A = torch.from_numpy(rng.standard_normal((40, 70)).astype(np.float32)).to(BF16)
    X = torch.from_numpy(rng.standard_normal((70, 30)).astype(np.float32))
    exact = A.double() @ X.double()
    scale = float((A.double().abs() @ X.double().abs()).max())
    err = float((tref.split_matmul(A, X).double() - exact).abs().max()) / scale
    rounded = float((A.double() @ X.to(BF16).double() - exact).abs().max()) / scale
    assert err <= 2.0 ** -15 and rounded > 8 * err


def test_bf16_ulp_ok_counts_one_ulp_at_the_terms_scale():
    """ref.bf16_ulp_ok, the card's check of the wgmma kernels against the
    split emulation: adjacent bf16 values pass, two ulps apart fail, and a
    cancelled element passes within one ulp of its terms' magnitude."""
    x = torch.tensor([1.0, 3.0, -0.75, 256.0], dtype=BF16)
    bits = x.view(torch.int16)
    up1 = (bits + 1).view(BF16)
    up2 = (bits + 2).view(BF16)
    assert tref.bf16_ulp_ok(up1, x) and not tref.bf16_ulp_ok(up2, x)
    tiny = torch.tensor([2.0 ** -10], dtype=BF16)
    off = torch.tensor([2.0 ** -10 + 2.0 ** -12], dtype=BF16)
    assert not tref.bf16_ulp_ok(off, tiny)
    assert tref.bf16_ulp_ok(off, tiny, torch.tensor([1.0]))


@pytest.mark.parametrize("m,b,n", SHAPES)
@pytest.mark.parametrize("op", ["wy_apply", "stacked_apply"])
def test_split_emulation_matches_jax_tile_programs(op, m, b, n):
    """The bf16 K2 and K4 of the card (split operands, f32 sums), emulated
    in f32 (ref.wy_apply_split, ref.stacked_apply_split), within the bf16
    tolerance of the JAX package's tile programs (wy_apply_math,
    stacked_apply_math) on the reference's bf16 parity shapes, every
    output bf16."""
    pairs = [both(x) for x in _inputs(op, m, b, n, seed=m * 100 + b)]
    got = _SPLIT[op](*[p[0] for p in pairs])
    want = _JAX_MATH[op](*[p[1] for p in pairs])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert all(g.dtype == BF16 for g in got)
    close(got, want)


@pytest.mark.parametrize("kind", ["BBF", "BFF", "BFB"])
def test_gemm_split_emulates_the_wide_bf16_mixes(kind):
    """wide.gemm_split, the emulation the card holds the bf16 wide products
    to, within the bf16 tolerance of the plain product (wide.gemm_plain on
    the widened operands) at each of the routes' three mixes, in the
    output dtype each mix stores."""
    rng = np.random.default_rng(13)
    A = torch.from_numpy(rng.standard_normal((2, 37, 150)).astype(np.float32)).to(BF16)
    B = torch.from_numpy(rng.standard_normal((2, 150, 29)).astype(np.float32))
    D = torch.from_numpy(rng.standard_normal((2, 37, 29)).astype(np.float32)).to(BF16)
    B = B.to(BF16) if kind == "BBF" else B
    out_dtype = BF16 if kind == "BFB" else torch.float32
    sub = kind == "BFB"
    Dk = D if kind != "BFF" else None
    got = twide.gemm_split(A, B, Dk, sub=sub, out_dtype=out_dtype)
    want = twide.gemm_plain(A.double(), B.double(),
                            None if Dk is None else Dk.double(), sub=sub)
    assert got.dtype == out_dtype
    close(got, want.numpy())


# -- K6: the whole panel ------------------------------------------------------

GEOMS = [("aligned", 4, 8, 16, 4), ("ragged", 4, 6, 10, 4), ("wide", 4, 4, 40, 4),
         ("b136", 2, 160, 272, 136)]


def test_fused_panel_bf16_matches_pallas_interpret():
    """K6 at bf16 (the port's plain fused_panel) against the JAX package's
    megakernel in interpret mode, on the first and the last panel's
    window of the padded ragged input (the interpreter compiles each
    panel's kernel anew, about 1.7 s a panel); ``tops`` exactly."""
    _, P, m_loc, n, b = GEOMS[1]
    A = np.random.default_rng(5).standard_normal((P, m_loc, n)).astype(np.float32)
    g = T.sweep_geometry(P, m_loc, n, b)
    A_pad = T.pad_to_geometry(T.SimComm(P), torch.from_numpy(A), g).numpy()
    for k in (0, g.n_panels - 1):
        win_t, win_j = both(A_pad[..., k * b:])
        got = ops.fused_panel(win_t, k, b=b, m_loc_pad=g.m_loc_pad,
                              levels=g.levels)
        want = jfused.fused_panel_pallas(win_j, k=k, b=b, m_loc_pad=g.m_loc_pad,
                                         levels=g.levels, interpret=True)
        for f in ("leaf_Y", "leaf_T", "R_leaf", "R_carry", "level_Y2",
                  "level_T", "C_local", "C_prime", "Ws", "Cs_self", "Cs_buddy"):
            assert got[f].dtype == BF16
            close(got[f], want[f])
        for a, w in zip(got["tops"], want["tops"]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


@pytest.mark.parametrize("geom", GEOMS, ids=lambda g: g[0])
def test_run_panel_fused_equals_run_steps_bf16(geom):
    """run_panel_fused == run_steps at bf16, bit for bit at every panel
    boundary and after finalize (torch against torch)."""
    _, P, m_loc, n, b = geom
    comm = T.SimComm(P)
    A = np.random.default_rng(6).standard_normal((P, m_loc, n)).astype(np.float32)
    s_f = s_s = tstate.initial_sweep_state(comm, both(A)[0], b)
    pts = tstate.panel_points(s_s.geom)
    while s_f.cursor is not None:
        s_f = tstate.run_panel_fused(comm, s_f)
        s_s = tstate.run_steps(comm, s_s, pts)
        fa, sa = tstate.flat_arrays(s_f), tstate.flat_arrays(s_s)
        assert s_f.cursor == s_s.cursor and fa.keys() == sa.keys()
        for key in fa:
            assert fa[key].dtype == sa[key].dtype
            assert torch.equal(fa[key], sa[key]), (s_s.cursor, key)
    for g_, w in zip(tstate.finalize(comm, s_f), tstate.finalize(comm, s_s)):
        for x, y in zip(g_ if isinstance(g_, tuple) else (g_,),
                        w if isinstance(w, tuple) else (w,)):
            assert torch.equal(x, y)


# -- the sweep ----------------------------------------------------------------

P, M_LOC, N, B = 4, 32, 24, 8


@pytest.mark.parametrize("use_scan", [False, True], ids=["windowed", "full-width"])
def test_caqr_factorize_bf16_matches_reference(use_scan):
    """caqr_factorize of a bf16 matrix: R within the bf16 tolerance of the
    JAX package's, replicated bitwise, the geometry exact."""
    A_t, A_j = both(np.random.default_rng(7).standard_normal((P, M_LOC, N)))
    got = T.caqr_factorize(A_t, T.SimComm(P), B, use_scan=use_scan)
    want = J.caqr_factorize(A_j, J.SimComm(P), B, use_scan=use_scan)
    assert got.R.dtype == BF16 and want.R.dtype == jnp.bfloat16
    close(got.R, want.R)
    assert bool((got.R == got.R[:1]).all())
    assert T.sweep_geometry(P, M_LOC, N, B) == J.sweep_geometry(P, M_LOC, N, B)


def test_ft_sweep_bf16_two_kills_matches_reference():
    """ft_caqr_sweep at bf16 with two kills: in the port R, factors and
    bundles bit-equal to the failure-free sweep; against the JAX package
    the RecoveryEvent ledgers exactly and R within the bf16 tolerance."""
    A = np.random.default_rng(8).standard_normal((P, M_LOC, N))
    A_t, A_j = both(A)
    events = {sweep_point(0, "tsqr", 1): [1], sweep_point(2, "trailing", 0): [2]}
    clean = T.caqr_factorize(A_t, T.SimComm(P), B, collect_bundles=True,
                             use_scan=False)
    got = ft_caqr_sweep(A_t, T.SimComm(P), B, schedule=FailureSchedule(events=events))
    for x, y in zip((got.R, *got.factors, *got.bundles),
                    (clean.R, *clean.factors, *clean.bundles)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    want = jft.ft_caqr_sweep(A_j, J.SimComm(P), B,
                             schedule=jft.FailureSchedule(events=events))
    assert [(e.point, e.lane, e.reads) for e in got.events] == \
        [(e.point, e.lane, e.reads) for e in want.events]
    assert len(got.events) == 2
    close(got.R, want.R)


# -- above 128 columns ----------------------------------------------------------

# P = 2 lanes of 160 rows, 272 columns: two panels of b = 136, the width at
# which the port's kernels take their blocked routes (sub-panels of 128).
WIDE = (2, 160, 272, 136)
WIDE_KILL = {sweep_point(0, "trailing", 0): [1]}


@pytest.fixture(scope="module")
def wide_ref():
    """The wide geometry's input and the JAX package's bf16 R on it,
    computed once: caqr_factorize's scan form, jitted (the windowed form's
    bits, in a fifth of the time)."""
    P, m_loc, n, b = WIDE
    A = np.random.default_rng(11).standard_normal((P, m_loc, n))
    A_t, A_j = both(A)
    R = jax.jit(lambda a: J.caqr_factorize(a, J.SimComm(P), b, use_scan=True).R)(A_j)
    return A_t, R


def close_rows(got, want):
    """R against the JAX package's R with each row's sign set by its
    diagonal (sign(0) = +1) on both sides, then as ``close``: an R factor
    is unique up to its rows' signs, and at this size some pivots' entries
    fall below bf16's round-off of their columns (the trailing rows of a
    leaf with few rows left), where either reflector is a valid choice and
    the port's plain versions (bf16 throughout) and the JAX package's
    (dots accumulating in f32) choose differently."""
    g = got.double().numpy()
    w = np.asarray(want, np.float64)
    def signed(x):
        d = np.diagonal(x, axis1=-2, axis2=-1)
        return x * np.where(d < 0, -1.0, 1.0)[..., None]
    close(torch.from_numpy(signed(g)), signed(w))


def test_caqr_factorize_bf16_above_128_matches_reference(wide_ref):
    """caqr_factorize of a bf16 matrix at b = 136: R within the bf16
    tolerance of the JAX package's (``close_rows``), replicated bitwise."""
    A_t, R_ref = wide_ref
    P, _, _, b = WIDE
    got = T.caqr_factorize(A_t, T.SimComm(P), b, use_scan=False)
    assert got.R.dtype == BF16 and R_ref.dtype == jnp.bfloat16
    close_rows(got.R, R_ref)
    assert bool((got.R == got.R[:1]).all())


def test_ft_sweep_bf16_above_128_kill_matches_reference(wide_ref):
    """ft_caqr_sweep at bf16 and b = 136 with one kill: R, factors and
    bundles bit-equal to the failure-free sweep in the port, the kill in
    the ledger, and R within the bf16 tolerance of the JAX package's
    (``close_rows``; the ledger against the JAX package's is
    ``test_ft_sweep_bf16_two_kills_matches_reference``'s)."""
    A_t, R_ref = wide_ref
    P, _, _, b = WIDE
    clean = T.caqr_factorize(A_t, T.SimComm(P), b, collect_bundles=True,
                             use_scan=False)
    got = ft_caqr_sweep(A_t, T.SimComm(P), b,
                        schedule=FailureSchedule(events=WIDE_KILL))
    for x, y in zip((got.R, *got.factors, *got.bundles),
                    (clean.R, *clean.factors, *clean.bundles)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    ((point, lanes),) = WIDE_KILL.items()
    assert [(e.point, e.lane) for e in got.events] == [(point, lanes[0])]
    close_rows(got.R, R_ref)


@pytest.mark.parametrize("fused", [False, True], ids=["stepped", "fused"])
def test_state_machine_bf16_above_128_matches_reference(wide_ref, fused):
    """The state machine at bf16 and b = 136, stepped (run_steps) or fused
    (run_panel_fused): R bit-equal to the port's caqr_factorize and within
    the bf16 tolerance of the JAX package's (``close_rows``)."""
    A_t, R_ref = wide_ref
    P, _, _, b = WIDE
    comm = T.SimComm(P)
    s = tstate.initial_sweep_state(comm, A_t, b)
    pts = tstate.panel_points(s.geom)
    while s.cursor is not None:
        s = tstate.run_panel_fused(comm, s) if fused else tstate.run_steps(comm, s, pts)
    R = tstate.finalize(comm, s)[0]
    want = T.caqr_factorize(A_t, comm, b, use_scan=False).R
    assert R.dtype == BF16 and torch.equal(R, want)
    close_rows(R, R_ref)
