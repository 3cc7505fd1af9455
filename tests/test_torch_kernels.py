"""The port's kernels K1-K4 (``repro_torch.kernels``) against the JAX
package's Pallas kernels (run in interpret mode) and its jnp oracles.

On this CPU the port's ops run their plain PyTorch versions; the CUDA
kernels themselves are held against those plain versions by
``tests/test_torch_cuda.py``, which skips without a GPU. Inputs are
made with numpy from a seed and fed to both packages. Floats are compared
at the JAX package's f32 tolerance, ``atol = 3e-4 * max(1, max|ref|)``.
"""
import inspect

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import panel_qr as jpanel
from repro.kernels import ref as jref
from repro.kernels import stacked_qr as jstacked
from repro.kernels import wy_apply as jwy
from repro_torch.kernels import backend, ops
from repro_torch.kernels import panel_qr as tpanel
from repro_torch.kernels import ref as tref
from repro_torch.kernels import stacked_qr as tstacked
from repro_torch.kernels import wy_apply as twy
from test_torch_cuda import STACKED_EDGES, stacked_edge_pair

RTOL, ATOL = jref.tolerances(jnp.float32)


def close(got, want):
    """Each float output of the port within tolerance of the reference."""
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        g = g.numpy().astype(np.float64) if isinstance(g, torch.Tensor) else g
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=ATOL * max(1.0, np.abs(w).max(initial=0)))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def qr_factor(rng, b):
    """A well-conditioned upper-triangular b x b R factor."""
    return np.linalg.qr(rng.standard_normal((2 * b, b)))[1].astype(np.float32)


def test_tolerance_table_is_the_reference_table():
    for name in ("float32", "bfloat16", "float16", "float64"):
        assert tref.tolerances(getattr(torch, name)) == jref.tolerances(name)


@pytest.mark.parametrize("m,b", [(32, 8), (64, 16), (37, 5), (128, 32)])
@pytest.mark.parametrize("row_start", [0, 8])
def test_panel_qr_matches_pallas_interpret(rng, m, b, row_start):
    A = rng.standard_normal((m, b)).astype(np.float32)
    want = jpanel.panel_qr(jnp.asarray(A), row_start, interpret=True)
    close(ops.panel_qr(t(A), row_start), want)
    close(tpanel.panel_qr_plain(t(A), row_start), jref.panel_qr(jnp.asarray(A), row_start))


@pytest.mark.parametrize("m,b,row_start", [(256, 32, 0), (128, 128, 0), (9, 3, 6), (8, 8, 0)])
def test_panel_qr_odd_and_wide_shapes(rng, m, b, row_start):
    A = rng.standard_normal((m, b)).astype(np.float32)
    close(ops.panel_qr(t(A), row_start), jref.panel_qr(jnp.asarray(A), row_start))


def test_panel_qr_degenerate_columns_and_late_row_start(rng):
    """Zero columns give tau = 0 and v = e_pivot; a row_start past m - b
    clamps the R rows as lax.dynamic_slice does."""
    A = rng.standard_normal((16, 4)).astype(np.float32)
    A[:, 1] = 0.0
    for rs in (0, 13):
        close(ops.panel_qr(t(A), rs), jref.panel_qr(jnp.asarray(A), rs))


def test_panel_qr_lane_batched_per_lane_row_start(rng):
    P, m, b = 4, 24, 4
    A = rng.standard_normal((P, m, b)).astype(np.float32)
    rs = np.array([0, 4, 8, 20], np.int32)
    Y, T, R = ops.panel_qr(t(A), torch.from_numpy(rs))
    for p in range(P):
        close((Y[p], T[p], R[p]), jref.panel_qr(jnp.asarray(A[p]), int(rs[p])))


@pytest.mark.parametrize("b", [8, 16, 5, 64, 33, 100, 128])
def test_stacked_qr_matches_pallas_interpret(rng, b):
    R1, R2 = qr_factor(rng, b), qr_factor(rng, b)
    want = jstacked.stacked_qr(jnp.asarray(R1), jnp.asarray(R2), interpret=True)
    close(ops.stacked_qr(t(R1), t(R2)), want)
    close(tstacked.stacked_qr_plain(t(R1), t(R2)),
          jref.stacked_qr(jnp.asarray(R1), jnp.asarray(R2)))


@pytest.mark.parametrize("case", STACKED_EDGES)
@pytest.mark.parametrize("b", [16, 33])
def test_stacked_qr_edge_inputs_match_pallas_interpret(rng, case, b):
    """The plain K3, which the CUDA kernel is held to, agrees with the
    Pallas kernel on the edge inputs: zero triangles, garbage below the
    diagonals, exactly degenerate and underflowing columns."""
    R1, R2 = stacked_edge_pair(rng, case, b)
    want = jstacked.stacked_qr(jnp.asarray(R1), jnp.asarray(R2), interpret=True)
    close(ops.stacked_qr(t(R1), t(R2)), want)


# The odd shapes are those the CUDA kernel's tiling makes hard (its
# 128-row blocks, 16-row slices, 32/64/128-column tiles and float4
# accesses): b in {4, 33, 100, 128}, n off the tile and off 4, m off the
# row blocks, one column.
@pytest.mark.parametrize("m,b,n", [(64, 16, 48), (256, 32, 300), (37, 5, 13),
                                   (130, 4, 1), (200, 33, 67),
                                   (129, 100, 130), (300, 128, 259)])
def test_wy_apply_matches_pallas_interpret(rng, m, b, n):
    Y = rng.standard_normal((m, b)).astype(np.float32) * 0.1
    T = np.triu(rng.standard_normal((b, b))).astype(np.float32) * 0.1
    C = rng.standard_normal((m, n)).astype(np.float32)
    args = [jnp.asarray(x) for x in (Y, T, C)]
    close(ops.wy_apply(t(Y), t(T), t(C)), jwy.wy_apply(*args, block_n=64, interpret=True))
    close(twy.wy_apply_plain(t(Y), t(T), t(C)), jref.wy_apply(*args))


def test_wy_apply_strided_window(rng):
    """The sweep passes its live window as a strided view."""
    P, m, b, n = 3, 16, 4, 20
    Y = rng.standard_normal((P, m, b)).astype(np.float32) * 0.1
    T = np.triu(rng.standard_normal((P, b, b))).astype(np.float32)
    A = rng.standard_normal((P, m, n)).astype(np.float32)
    got = ops.wy_apply(t(Y), t(T), t(A)[..., 7:])
    for p in range(P):
        close(got[p], jref.wy_apply(*[jnp.asarray(x) for x in (Y[p], T[p], A[p, :, 7:])]))


@pytest.mark.parametrize("b,n", [(16, 40), (32, 128), (5, 11), (4, 1),
                                 (33, 70), (100, 259), (128, 130)])
def test_stacked_apply_matches_pallas_interpret(rng, b, n):
    Y2 = np.triu(rng.standard_normal((b, b))).astype(np.float32) * 0.1
    T = np.triu(rng.standard_normal((b, b))).astype(np.float32) * 0.1
    Ct = rng.standard_normal((b, n)).astype(np.float32)
    Cb = rng.standard_normal((b, n)).astype(np.float32)
    args = [jnp.asarray(x) for x in (Y2, T, Ct, Cb)]
    got = ops.stacked_apply(t(Y2), t(T), t(Ct), t(Cb))
    close(got, jstacked.stacked_apply(*args, block_n=32, interpret=True))
    close(tstacked.stacked_apply_plain(t(Y2), t(T), t(Ct), t(Cb)), jref.stacked_apply(*args))


@pytest.mark.parametrize("P,n,bn", [(8, 4096, 128), (8, 2048, 64),
                                    (8, 512, 32), (1, 4096, 32),
                                    (8, 128, 32), (132, 1, 128)])
def test_tile_bn_fills_the_card(P, n, bn):
    """K2/K4's column tile: the widest whose (lane, tile) grid gives each of
    132 SMs a block (the tall sweep's first panel, a late panel, a
    one-lane REBUILD replay)."""
    assert backend.tile_bn(P, n, 132) == bn


@pytest.mark.parametrize("m,b,C,in_smem", [
    (4096, 128, 16, True),   # the tall cell's panel: 16 slabs of 256 rows
    (512, 128, 2, True),     # the square cell's panel
    (1000, 96, 2, True),
    (8192, 128, 16, False),  # even 512-row slabs overflow shared memory
    (37, 5, 1, True),
    (128, 128, 1, True),
    (20000, 100, 16, False)])
def test_team_blocks_rule(m, b, C, in_smem):
    """K1's team size depends on (m, b) only; it is the smallest power of
    two whose slabs fit in shared memory (else 16, with the slabs in
    global scratch); the slabs cover the m rows with none empty; and a
    block's shared memory stays within Hopper's limit."""
    assert backend.team_blocks(m, b) == C
    assert backend.team_slab_in_smem(m, b, C) == in_smem
    rows = backend.team_rows(m, C)
    assert C * rows >= m and (C - 1) * rows < m
    assert backend.team_smem_bytes(m, b, C, in_smem) <= backend.SMEM_LIMIT
    if C > 1:
        assert not backend.team_slab_in_smem(m, b, C // 2)
    # the rule takes nothing but (m, b): not the lane count, not the card
    assert list(inspect.signature(backend.team_blocks).parameters) == ["m", "b"]


def test_launch_bn_checks_a_given_tile():
    x = torch.zeros(1)
    assert backend.launch_bn(8, 4096, x, 64) == 64
    with pytest.raises(ValueError):
        backend.launch_bn(8, 4096, x, 48)


def test_cpu_tensors_run_the_plain_engine(rng):
    A = t(rng.standard_normal((8, 4)).astype(np.float32))
    ops.panel_qr(A, 0)
    report = backend.probe_report()
    assert report["panel_qr"]["engine"] == backend.ENGINE_PLAIN
    assert set(report) == set(backend.OPS)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel on CUDA tensors or raises; it never
    computes a CPU tensor some other way."""
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        tpanel.panel_qr(x, 0)
    with pytest.raises(ValueError):
        twy.wy_apply(x, torch.zeros(4, 4), x)
    with pytest.raises(ValueError):
        tstacked.stacked_qr(torch.zeros(4, 4), torch.zeros(4, 4))


def test_ops_refuse_other_devices():
    """A call whose tensors are not all on the CPU, all on the card or all
    on the meta device (the dry run's shapes) raises."""
    x = torch.zeros(8, 4)
    with pytest.raises(ValueError):
        ops.wy_apply(x, torch.zeros(4, 4), torch.zeros(8, 4, device="meta"))
    with pytest.raises(ValueError):
        ops.stacked_qr(torch.zeros(4, 4), torch.zeros(4, 4, device="meta"))


def test_launch_counters_reset():
    backend.LAUNCHES["wy_apply"] += 3
    backend.reset_launches()
    assert all(v == 0 for v in backend.LAUNCHES.values())
