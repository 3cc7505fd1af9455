"""The port's Adafactor (``repro_torch.optim.adafactor``) against the JAX
package's on the same numpy inputs, CPU tensors.

Three successive updates from each package's own state, on a tree with
1-D, 2-D and 3-D leaves, a (1, n) leaf (not factored) and a bf16 leaf:
updates, ``vr`` and ``vc`` within rtol 1e-5, atol 1e-7 at every step.
The state crosses both ways through ``interop.adafactor_state_*``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ckpt.save import _flatten as j_flatten
from repro.optim.adafactor import adafactor as j_adafactor
from repro_torch import interop, tree
from repro_torch.optim import adafactor as t_adafactor
from repro_torch.optim.adamw import Optimizer

RTOL, ATOL = 1e-5, 1e-7
LR = 1e-3
SHAPES = {"bias": ((7,), np.float32), "w": ((6, 5), np.float32),
          "stack": ((3, 4, 5), np.float32), "row": ((1, 9), np.float32),
          "half": ((4, 6), jnp.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _trees(rng):
    """(jax params, port params) from the same numpy draws."""
    draws = {k: rng.standard_normal(s).astype(np.float32)
             for k, (s, _) in SHAPES.items()}
    jp = {k: jnp.asarray(draws[k], SHAPES[k][1]) for k in draws}
    tp = {k: torch.from_numpy(np.array(jp[k], np.float32)).to(
        torch.bfloat16 if SHAPES[k][1] == jnp.bfloat16 else torch.float32)
        for k in draws}
    return jp, tp


def _close(got, want, what):
    for (path, g), w in zip(tree.flatten_with_path(got),
                            jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(_host(g), _host(w), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} {path}")


def test_adafactor_matches_jax_over_three_steps():
    rng = np.random.default_rng(0)
    jp, tp = _trees(rng)
    jopt, topt = j_adafactor(), t_adafactor.adafactor()
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts.vc["bias"].shape == (0,) and ts.vc["row"].shape == (0,)
    assert ts.vr["row"].shape == (1, 9) and ts.vc["stack"].shape == (3, 5)
    for step in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, (s, _) in SHAPES.items()}
        jg = {k: jnp.asarray(v, SHAPES[k][1]) for k, v in g.items()}
        tg = {k: torch.from_numpy(np.array(jg[k], np.float32)).to(tp[k].dtype)
              for k in g}
        ju, js = jopt.update(jg, js, jp, LR)
        tu, ts = topt.update(tg, ts, tp, LR)
        assert int(ts.step) == int(js.step) == step + 1
        _close(tu, ju, f"step {step} update")
        _close(ts.vr, js.vr, f"step {step} vr")
        _close(ts.vc, js.vc, f"step {step} vc")
        for k in tp:
            assert tu[k].dtype == tp[k].dtype
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tp = {k: tp[k] + tu[k] for k in tp}


def test_adafactor_state_crosses_from_jax_and_back():
    """A JAX state carried across gives the port JAX's next update; the
    port's state written out reads back equal."""
    rng = np.random.default_rng(1)
    jp, tp = _trees(rng)
    jopt, topt = j_adafactor(decay=0.7), t_adafactor.adafactor(decay=0.7)
    js = jopt.init(jp)
    g = {k: rng.standard_normal(s).astype(np.float32) for k, (s, _) in SHAPES.items()}
    jg = {k: jnp.asarray(v, SHAPES[k][1]) for k, v in g.items()}
    tg = {k: torch.from_numpy(np.array(jg[k], np.float32)).to(tp[k].dtype)
          for k in g}
    _, js = jopt.update(jg, js, jp, LR)
    ts = interop.adafactor_state_from_arrays(j_flatten(js), tp)
    assert ts.step.dtype == torch.int32 and ts.vr["w"].dtype == torch.float32
    ju, js2 = jopt.update(jg, js, jp, LR)
    tu, ts2 = topt.update(tg, ts, tp, LR)
    _close(tu, ju, "update from carried state")
    _close(ts2.vr, js2.vr, "vr from carried state")
    back = interop.adafactor_state_to_arrays(ts2)
    want = j_flatten(js2)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_allclose(back[k], np.asarray(want[k], np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=k)


def test_adafactor_recipe_rebuilds_it():
    opt = t_adafactor.adafactor(decay=0.6, clip_threshold=2.0)
    assert isinstance(opt, Optimizer)
    factory, kw = opt.recipe
    again = factory(**kw)
    assert again.recipe == opt.recipe
    p = {"w": torch.ones(3, 4)}
    g = {"w": torch.arange(12.0).reshape(3, 4)}
    u1, _ = opt.update(g, opt.init(p), p, LR)
    u2, _ = again.update(g, again.init(p), p, LR)
    assert torch.equal(u1["w"], u2["w"])
