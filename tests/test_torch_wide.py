"""Panel widths above 128 (``repro_torch.kernels.wide``) against the JAX
package on the same numpy inputs, CPU tensors, f32.

On this CPU the port's ops run their unblocked plain versions at any b;
on the card, b > 128 takes the blocked routes of ``kernels/wide.py``,
which are functions of their sub-kernels. Here those routes run with the
plain bodies (``wide.PLAIN``) and are held against the unblocked plain
versions and against JAX: K1 in sub-panels of 128 columns (ragged last
sub-panel, clamped R rows), K2 with a random T that is not Y's own, K3 as
K1's route on the stack, K4. Then the paths that reach b > 128 on the
card, against JAX: ``householder_qr_masked``, ``stacked_qr`` and
``stacked_apply_qt`` at b = 160, ``caqr_factorize`` at panel width 256,
``_orth2d`` on a 512 x 160 momentum, and one ``Trainer(caqr_muon)`` step
of a one-layer model whose wq, wo and MLP matrices are all wider than
128. Floats within the f32 pair of ``repro.kernels.ref.tolerances``,
``atol = 3e-4 * max(1, max|ref|)``; the Muon outputs times the input's
condition number, since Q = A R^-1 amplifies a last-bit difference of R
by cond(A).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.ckpt import save as j_save
from repro.configs import get_smoke as j_get_smoke
from repro.data import pipeline as j_pipe
from repro.kernels.ref import tolerances
from repro.models import transformer as j_tf
from repro.optim import caqr_muon as j_muon
from repro.optim.schedule import warmup_cosine
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_train_step
import repro_torch.core as T
from repro_torch import interop
from repro_torch.configs import get_smoke
from repro_torch.data import pipeline as t_pipe
from repro_torch.kernels import ref, wide
from repro_torch.optim import caqr_muon as t_muon
from repro_torch.train import TrainConfig, Trainer, TrainState

RTOL, ATOL = tolerances(np.float32)
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread in this module: under xdist six workers' thread
    teams would spin against each other (``tests/test_torch_moe.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(got, want, scale=1.0):
    if not isinstance(got, (tuple, list)):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        g = g.numpy().astype(np.float64) if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape
        np.testing.assert_allclose(
            g, w, rtol=RTOL, atol=ATOL * scale * max(1.0, np.abs(w).max(initial=0)))


def qr_factor(rng, b):
    """A well-conditioned upper-triangular b x b R factor."""
    return np.linalg.qr(rng.standard_normal((2 * b, b)))[1].astype(np.float32)


# -- the blocked routes with the plain bodies --------------------------------


@pytest.mark.parametrize("m,b,row_start", [
    (400, 129, 0), (300, 200, 7), (512, 256, 100), (600, 384, 216),
    (600, 300, 500),  # row start past m - b: R's rows clamped to m - b
    (300, 200, 400),  # every pivot below the panel: all columns degenerate
    (256, 256, 0), (300, 300, 0),  # square, as the Muon path's leaves are
    (640, 300, 17),   # sub-panels of 128, 128 and 44 columns
])
def test_blocked_panel_qr_matches_unblocked(rng, m, b, row_start):
    A = t(rng.standard_normal((2, m, b)).astype(np.float32))
    rs = torch.tensor([row_start, max(row_start - 3, 0)])
    got = wide.panel_qr_blocked(A, rs, **wide.PLAIN)
    close(got, ref.panel_qr(A, rs))
    Y = got[0]
    assert torch.equal(Y, Y.tril()) or row_start > 0  # unit lower trapezoidal
    assert torch.equal(got[2], got[2].triu())


@pytest.mark.parametrize("b", [129, 200, 256, 300, 384])
def test_blocked_apply_and_stacked_match_unblocked(rng, b):
    """K2 with a random upper-triangular T (not Y's own) and with Y's own;
    K3 on two R factors (Y2 exactly upper triangular, Y[:b] exactly I);
    K4 with a random T."""
    P, m, n = 2, b + 37, 45
    Y = t(rng.standard_normal((P, m, b)).astype(np.float32))
    Tr = t(np.triu(rng.standard_normal((P, b, b))).astype(np.float32) / 8)
    C = t(rng.standard_normal((P, m, n)).astype(np.float32))
    close(wide.wy_apply_wide(Y, Tr, C, gemm=wide.gemm_plain), ref.wy_apply(Y, Tr, C))
    Yq, Tq, _ = ref.panel_qr(Y, 0)
    close(wide.wy_apply_wide(Yq, Tq, C, gemm=wide.gemm_plain),
          ref.wy_apply(Yq, Tq, C))
    Rt = t(np.stack([qr_factor(rng, b) for _ in range(P)]))
    Rb = t(np.stack([qr_factor(rng, b) for _ in range(P)]))
    got = wide.stacked_qr_wide(Rt, Rb, **wide.PLAIN)
    close(got, ref.stacked_qr(Rt, Rb))
    if b == 129:  # the stack's zeros stay exact zeros
        S = torch.cat([Rt.triu(), Rb.triu()], dim=-2)
        Yfull = wide.panel_qr_blocked(S, torch.zeros(P, dtype=torch.int64),
                                      **wide.PLAIN)[0]
        assert torch.equal(Yfull[:, :b], torch.eye(b).expand(P, b, b))
        assert torch.equal(Yfull[:, b:], Yfull[:, b:].triu())
    Ct = t(rng.standard_normal((P, b, n)).astype(np.float32))
    Cb = t(rng.standard_normal((P, b, n)).astype(np.float32))
    close(wide.stacked_apply_wide(got[0], Tr, Ct, Cb, gemm=wide.gemm_plain),
          ref.stacked_apply(got[0], Tr, Ct, Cb))


def test_blocked_panel_qr_three_lanes(rng):
    """Three lanes of one call from row starts 0, 37 and past m - b (R's
    rows clamped), each equal to its own one-lane call of the route and
    within tolerance of the unblocked plain version."""
    m, b = 400, 200
    A = t(rng.standard_normal((3, m, b)).astype(np.float32))
    rs = torch.tensor([0, 37, 350])
    got = wide.panel_qr_blocked(A, rs, **wide.PLAIN)
    close(got, ref.panel_qr(A, rs))
    for k in range(3):
        one = wide.panel_qr_blocked(A[k:k + 1], rs[k:k + 1], **wide.PLAIN)
        close(tuple(x[k] for x in got), tuple(x[0] for x in one))


# -- the port against JAX at b > 128 ------------------------------------------


@pytest.mark.parametrize("m,b,row_start", [(300, 200, 0), (512, 256, 100),
                                           (256, 256, 0), (640, 300, 17)])
def test_householder_qr_masked_matches_jax(rng, m, b, row_start):
    A = rng.standard_normal((m, b)).astype(np.float32)
    want = J.householder_qr_masked(jnp.asarray(A), jnp.int32(row_start))
    want = (want.Y, want.T, want.R)
    close(tuple(T.householder_qr_masked(t(A), row_start)), want)
    close(wide.panel_qr_blocked(t(A)[None], torch.tensor([row_start]),
                                **wide.PLAIN), tuple(w[None] for w in want))


def test_stacked_qr_and_apply_match_jax_at_160(rng):
    b, n = 160, 70
    Rt, Rb = qr_factor(rng, b), qr_factor(rng, b)
    want = J.stacked_qr(jnp.asarray(Rt), jnp.asarray(Rb))
    got = T.stacked_qr(t(Rt), t(Rb))
    close((got.Y2, got.T, got.R), (want.Y2, want.T, want.R))
    blocked = wide.stacked_qr_wide(t(Rt)[None], t(Rb)[None], **wide.PLAIN)
    close(blocked, tuple(x[None] for x in (want.Y2, want.T, want.R)))
    Ct = rng.standard_normal((b, n)).astype(np.float32)
    Cb = rng.standard_normal((b, n)).astype(np.float32)
    jw = J.stacked_apply_qt(want, jnp.asarray(Ct), jnp.asarray(Cb))
    close(T.stacked_apply_qt(got, t(Ct), t(Cb)), jw)
    close(wide.stacked_apply_wide(got.Y2, got.T, t(Ct), t(Cb),
                                  gemm=wide.gemm_plain), jw)


def test_caqr_factorize_matches_jax_at_panel_width_256(rng):
    P, m_loc, n, b = 2, 512, 512, 256
    A = rng.standard_normal((P, m_loc, n)).astype(np.float32)
    got = T.caqr_factorize(t(A), T.SimComm(P), b, collect_bundles=True,
                           use_scan=False)
    # jitted: one compile of the sweep takes half the time of JAX's
    # op-by-op compiles
    want = jax.jit(lambda X: J.caqr_factorize(
        X, J.SimComm(P), b, collect_bundles=True, use_scan=False).R)(jnp.asarray(A))
    close(got.R, want)
    assert torch.equal(got.R[0], got.R[1])
    G = A.reshape(-1, n).astype(np.float64)
    R = got.R[0].double().numpy()
    assert np.abs(R.T @ R - G.T @ G).max() <= 1e-5 * np.abs(G.T @ G).max()


def test_orth2d_matches_jax_at_160(rng):
    M = rng.standard_normal((512, 160)).astype(np.float32)
    got = t_muon._orth2d(t(M)).numpy()
    want = np.asarray(j_muon._orth2d(jnp.asarray(M)))
    close(got, want, scale=np.linalg.cond(M))
    np.testing.assert_allclose(got.T @ got, np.eye(160), atol=1e-4)


def _wide_cfg(get):
    """A one-layer model whose wq, wo (160 x 160) and MLP (160 x 320)
    matrices have short sides over 128."""
    return dataclasses.replace(get(ARCH), n_layers=1, d_model=160, n_heads=4,
                               n_kv_heads=2, d_ff=320)


def test_muon_trainer_step_matches_jax_above_128():
    """The port's Trainer step against the step JAX's Trainer jits
    (``make_train_step`` with the CAQR-Muon optimizer and the warmup-cosine
    schedule, on the full batch of its two live lanes), from JAX's
    initial state, which is made jitted (a third of the op-by-op time)."""
    kw = dict(steps=3, lr=1e-2, warmup=1, n_lanes=2, diskless_every=2,
              log_every=100, optimizer="caqr_muon")
    dc = dict(vocab=256, seq_len=16, global_batch=4, seed=1)
    jcfg = _wide_cfg(j_get_smoke)
    jopt = j_muon.caqr_muon()
    jparams = jax.jit(functools.partial(j_tf.init_params, jcfg))(jax.random.key(1))
    state = JTrainState(jparams, jopt.init(jparams), jnp.zeros((), jnp.int32))
    step = jax.jit(make_train_step(jcfg, jopt, warmup_cosine(1e-2, 1, 3)))
    batch = {k: jnp.asarray(v) for k, v in
             j_pipe.make_batch(j_pipe.DataConfig(**dc), 0).items()}
    want, jm = step(state, batch)
    cfg = _wide_cfg(get_smoke)
    tt = Trainer(cfg, TrainConfig(**kw), t_pipe.DataConfig(**dc), device="cpu")
    params = interop.params_from_arrays(j_save._flatten(state.params), cfg,
                                        device="cpu")
    opt = interop.opt_state_from_arrays(j_save._flatten(state.opt_state),
                                        params, "caqr_muon")
    carried = TrainState(params, opt, torch.tensor(int(state.step), dtype=torch.int32))
    got, tm = tt._step_fn(carried, tt._lane_batch(0))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL)
    w, g = j_save._flatten(want.params), interop.opt_state_to_arrays(got.params)
    assert list(g) == list(w)
    wide_paths = [p for p in w if t_muon._is_muon(p, torch.empty(w[p].shape))
                  and min(w[p].shape[-2:]) > 128]
    assert len(wide_paths) == 5, wide_paths  # wq, wo and the three MLP matrices
    for path in w:
        np.testing.assert_allclose(g[path], w[path], rtol=RTOL, atol=ATOL,
                                   err_msg=path)
