"""The port's CUDA kernels K1-K4 against their plain PyTorch versions on
the card. Needs an NVIDIA GPU with nvcc; every test skips without one.

Imports neither JAX nor the JAX package, so it also runs on a machine
with the card and no JAX: ``python -m pytest -q tests/test_torch_cuda.py``.
Tolerance: the f32 pair of ``repro_torch.kernels.ref.tolerances``, as
``atol = 3e-4 * max(1, max|plain|)``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import SimComm, caqr_factorize, ft_tsqr, recovery
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
    assert all(v > 0 for v in backend.LAUNCHES.values()), backend.LAUNCHES
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
