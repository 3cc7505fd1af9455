"""The port's optimizers (``repro_torch.optim``) against the JAX package's,
on the same numpy inputs, CPU tensors, f32.

Within the f32 pair of ``repro.kernels.ref.tolerances``: ``adamw`` (two
successive updates from the same state), ``warmup_cosine``,
``muon_moments``/``muon_deltas`` on the smoke model's tree, the three
PowerSGD phases and ``compress_tree(axis_name=None)`` from JAX's state;
over a "pod" axis of two identical pods ``compress_tree`` equals the local
compression bit for bit (``tests/test_torch_pod.py`` holds it against
JAX over two ranks).
``_orth2d`` (tall, wide) and ``_orth`` (stacked) within the tolerance
times the condition number of the input: Q = A R^-1 amplifies a last-bit
difference of R by cond(R) = cond(A).
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ckpt.save import _flatten as j_flatten
from repro.configs import get_smoke as j_get_smoke
from repro.kernels.ref import tolerances
from repro.models import transformer as j_tf
from repro.optim import adamw as j_adamw
from repro.optim import caqr_muon as j_muon
from repro.optim import powersgd as j_psgd
from repro.optim import schedule as j_schedule
from repro_torch import interop, tree
from repro_torch.configs import get_smoke
from repro_torch.dist import compat
from repro_torch.optim import adamw as t_adamw
from repro_torch.optim import caqr_muon as t_muon
from repro_torch.optim import powersgd as t_psgd
from repro_torch.optim import schedule as t_schedule

RTOL, ATOL = tolerances(np.float32)
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def smoke_trees():
    """JAX's smoke params and a gradient-like tree of the same structure."""
    params = j_tf.init_params(j_get_smoke(ARCH), jax.random.key(0))
    rng = np.random.default_rng(3)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
    return params, grads


def _port(jtree, like):
    """A JAX tree's arrays as the port's tree of ``like``'s structure."""
    flat = j_flatten(jtree)
    return tree.map_with_path(lambda path, _: torch.from_numpy(np.array(flat[path])),
                              like)


def _close(got_tree, want_tree, rtol=RTOL, atol=ATOL):
    want = j_flatten(want_tree)
    got = dict(tree.flatten_with_path(got_tree))
    assert list(got) == list(want)
    for path, w in want.items():
        np.testing.assert_allclose(np.asarray(got[path]), w, rtol=rtol, atol=atol,
                                   err_msg=path)


def test_adamw_two_updates_match_jax(smoke_trees):
    jp, jg = smoke_trees
    cfg = get_smoke(ARCH)
    tp = interop.params_from_arrays(j_flatten(jp), cfg, device="cpu")
    tg = _port(jg, tp)
    jopt, topt = j_adamw.adamw(), t_adamw.adamw()
    js, ts = jopt.init(jp), topt.init(tp)
    for lr in (1e-2, 3e-3):
        ju, js = jopt.update(jg, js, jp, jnp.float32(lr))
        tu, ts = topt.update(tg, ts, tp, torch.tensor(lr))
        jp, tp = j_adamw.apply_updates(jp, ju), t_adamw.apply_updates(tp, tu)
        _close(tu, ju)
        _close(tp, jp)
    assert int(ts.step) == int(js.step) == 2
    _close(ts.mu, js.mu)
    _close(ts.nu, js.nu)


def test_warmup_cosine_and_constant_match_jax():
    jl, tl = j_schedule.warmup_cosine(3e-3, 10, 100), t_schedule.warmup_cosine(3e-3, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tl(step)), float(jl(step)), rtol=1e-6)
        np.testing.assert_allclose(float(tl(torch.tensor(step, dtype=torch.int32))),
                                   float(jl(step)), rtol=1e-6)
        assert tl(step).dtype == torch.float32
    assert float(t_schedule.constant(0.5)(7)) == float(j_schedule.constant(0.5)(7))


@pytest.mark.parametrize("shape", [(128, 16), (16, 96), (3, 64, 32)],
                         ids=["tall", "wide", "stacked"])
def test_orth_matches_jax(rng, shape):
    M = rng.standard_normal(shape).astype(np.float32)
    want = np.asarray(j_muon._orth(jnp.asarray(M)))
    got = t_muon._orth(torch.from_numpy(M)).numpy()
    cond = max(np.linalg.cond(m) for m in M.reshape((-1,) + shape[-2:]))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * cond)
    for q in got.reshape((-1,) + shape[-2:]):
        q = q if q.shape[0] >= q.shape[1] else q.T
        np.testing.assert_allclose(q.T @ q, np.eye(q.shape[1]), atol=1e-4)
    if len(shape) == 2:
        np.testing.assert_allclose(t_muon._orth2d(torch.from_numpy(M)).numpy(),
                                   np.asarray(j_muon._orth2d(jnp.asarray(M))),
                                   rtol=RTOL, atol=ATOL * cond)


def test_muon_moments_and_deltas_match_jax(smoke_trees):
    jp, jg = smoke_trees
    cfg = get_smoke(ARCH)
    tp = interop.params_from_arrays(j_flatten(jp), cfg, device="cpu")
    tg = _port(jg, tp)
    jopt, topt = j_muon.caqr_muon(), t_muon.caqr_muon()
    # a state one update in, so both moments are nonzero
    _, js = jopt.update(jg, jopt.init(jp), jp, jnp.float32(1e-2))
    ts = interop.opt_state_from_arrays(j_flatten(js), tp, "caqr_muon")
    assert isinstance(ts, t_muon.MuonState) and int(ts.step) == 1
    jmom, jnu = j_muon.muon_moments(jg, js, jp)
    tmom, tnu = t_muon.muon_moments(tg, ts, tp)
    _close(tmom, jmom)
    _close(tnu, jnu)
    jd = j_muon.muon_deltas(jp, jmom, jnu, jnp.float32(1e-2), jnp.float32(2.0))
    td = t_muon.muon_deltas(tp, tmom, tnu, torch.tensor(1e-2), torch.tensor(2.0))
    _close(td, jd)
    routed = [p for p, x in tree.flatten_with_path(tp) if t_muon._is_muon(p, x)]
    assert routed and not any(("embed" in p or "lm_head" in p) for p in routed)
    assert "groups/l0/attn/.wq" in routed


def test_powersgd_phases_match_jax(rng):
    G = rng.standard_normal((96, 40)).astype(np.float32)
    om = rng.standard_normal((40, 4)).astype(np.float32)
    err = (0.1 * rng.standard_normal((96, 40))).astype(np.float32)
    jGc, jP = j_psgd.psgd_project(jnp.asarray(G), jnp.asarray(om), jnp.asarray(err))
    tGc, tP = t_psgd.psgd_project(*(torch.from_numpy(x) for x in (G, om, err)))
    np.testing.assert_allclose(tGc.numpy(), np.asarray(jGc), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=RTOL, atol=ATOL)
    Q = np.linalg.qr(np.asarray(jP))[0].astype(np.float32)
    jR = j_psgd.psgd_rfactor(jGc, jnp.asarray(Q))
    tR = t_psgd.psgd_rfactor(tGc, torch.from_numpy(Q))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), rtol=RTOL, atol=ATOL)
    jH, jE = j_psgd.psgd_complete(jGc, jnp.asarray(Q), jR, jnp.float32)
    tH, tE = t_psgd.psgd_complete(tGc, torch.from_numpy(Q), tR, torch.float32)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tE.numpy(), np.asarray(jE), rtol=RTOL, atol=ATOL)


def test_compress_tree_matches_jax(smoke_trees):
    jp, jg = smoke_trees
    cfg = get_smoke(ARCH)
    tp = interop.params_from_arrays(j_flatten(jp), cfg, device="cpu")
    tg = _port(jg, tp)
    jst = j_psgd.init_state(jax.random.key(1), jp, rank=4)
    tst = t_psgd.init_state(torch.Generator().manual_seed(1), tp, rank=4)
    for jt, tt in ((jst.error, tst.error), (jst.sketch, tst.sketch)):
        assert [(p, tuple(x.shape)) for p, x in tree.flatten_with_path(tt)] == \
            [(p, x.shape) for p, x in j_flatten(jt).items()]
    # carry JAX's sketches across, then two rounds of compression
    tst = t_psgd.PowerSGDState(error=_port(jst.error, tp), sketch=_port(jst.sketch, tp))
    for _ in range(2):
        jout, jst = j_psgd.compress_tree(jg, jst, None, rank=4)
        tout, tst = t_psgd.compress_tree(tg, tst, None, rank=4)
        _close(tout, jout)
        _close(tst.error, jst.error)
        _close(tst.sketch, jst.sketch)
    # over a "pod" axis of two pods holding the same gradients and state
    # (threads of one process), the pod mean is the local compression bit
    # for bit: x + x and its half are exact
    mesh = compat.make_mesh((2,), ("pod",), device="cpu", threads=True)
    body = functools.partial(t_psgd.compress_tree, axis_name="pod", rank=4)
    local = t_psgd.compress_tree(tg, tst, None, rank=4)
    for pod in compat.run_manual(body, mesh, [(tg, tst)] * 2):
        assert all(torch.equal(a, b) for a, b in zip(tree.leaves(pod),
                                                     tree.leaves(local)))
