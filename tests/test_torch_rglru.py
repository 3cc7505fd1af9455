"""The port's RG-LRU block (``repro_torch.models.rglru``) and the
recurrentgemma family against the JAX package's, on CPU tensors.

Against JAX, on the same numpy-seeded inputs: the log-depth scan
``_lru_scan`` (doubling, where the reference takes
``jax.lax.associative_scan``), with and without a folded-in h0, within the
f32 pair of ``repro.kernels.ref.tolerances``; ``rglru_forward`` without a
state, and a prefill that returns its state followed by S = 1 decode steps
on it, the outputs and the states, at f32 and at bf16 (the bf16 pair), the
bf16 state h a bf16 value held in float32 as the reference's is (it casts h
to the activation dtype before it keeps the last position); one
``FTTrainer`` step (``caqr_muon``) of the recurrentgemma smoke from JAX's
carried state: the metrics, params and optimizer state. Inside the port,
bitwise: a lane killed inside a sweep heals to the failure-free run.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ckpt import save as j_save
from repro.configs import get_smoke as j_get_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.ft.semantics import Semantics as JSemantics
from repro.kernels.ref import tolerances
from repro.models import rglru as j_rglru
from repro.train import ftrun as J
from repro.train.loop import TrainConfig as JTrainConfig
from repro_torch import interop, tree
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.semantics import Semantics
from repro_torch.models import rglru as t_rglru
from repro_torch.train import TrainConfig, TrainState
from repro_torch.train import ftrun as T

RTOL, ATOL = tolerances(np.float32)
ARCH = "recurrentgemma-9b"
D, W, CW = 16, 24, 4


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while this module runs (it trains; see
    ``tests/test_torch_moe.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("with_h0", [False, True], ids=["no-h0", "h0"])
@pytest.mark.parametrize("S", [1, 37, 64])
def test_lru_scan_matches_jax(rng, with_h0, S):
    a = rng.uniform(0.5, 1.0, (2, S, W)).astype(np.float32)
    u = rng.standard_normal((2, S, W)).astype(np.float32)
    h0 = rng.standard_normal((2, W)).astype(np.float32) if with_h0 else None
    want = j_rglru._lru_scan(jnp.asarray(a), jnp.asarray(u),
                             None if h0 is None else jnp.asarray(h0))
    got = t_rglru._lru_scan(torch.from_numpy(a), torch.from_numpy(u),
                            None if h0 is None else torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _params(rng):
    arrays = dict(
        w_in=rng.standard_normal((D, 2 * W)) * 0.3,
        conv_w=rng.standard_normal((CW, W)) * 0.3,
        w_a=rng.standard_normal((W, W)) * 0.3, b_a=rng.standard_normal(W) * 0.1,
        w_x=rng.standard_normal((W, W)) * 0.3, b_x=rng.standard_normal(W) * 0.1,
        a_param=rng.standard_normal(W) * 0.5,
        w_out=rng.standard_normal((W, D)) * 0.3)
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _as(arrays, cls, lib, dtype):
    if lib is jnp:
        return cls(**{k: jnp.asarray(v, jnp.float32 if k == "a_param" else dtype)
                      for k, v in arrays.items()})
    return cls(**{k: torch.from_numpy(v).to(torch.float32 if k == "a_param" else dtype)
                  for k, v in arrays.items()})


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1], err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_forward_prefill_and_decode_match_jax(rng, dtype):
    """No state (S = 21), then a prefill of 21 that returns its state and 3
    decode steps (S = 1) on it."""
    tol = tolerances(np.float32 if dtype == "float32" else jnp.bfloat16)
    arrays = _params(rng)
    jp = _as(arrays, j_rglru.RGLRUParams, jnp, getattr(jnp, dtype))
    tp = _as(arrays, t_rglru.RGLRUParams, torch, getattr(torch, dtype))
    x = rng.standard_normal((2, 24, D)).astype(np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    _close(t_rglru.rglru_forward(tp, tx[:, :21]), j_rglru.rglru_forward(jp, jx[:, :21]),
           tol, "no state")
    jo, js = j_rglru.rglru_forward(jp, jx[:, :21], return_state=True)
    to, ts = t_rglru.rglru_forward(tp, tx[:, :21], return_state=True)
    _close(to, jo, tol, "prefill")
    for t in range(21, 24):
        _close(ts.h, js.h, tol, f"h before {t}")
        _close(ts.conv, js.conv, tol, f"conv before {t}")
        # the state is h cast to the activation dtype, kept in float32
        for h in (ts.h, torch.from_numpy(np.array(js.h))):
            assert h.dtype == torch.float32
            assert torch.equal(h, h.to(getattr(torch, dtype)).float())
        jo, js = j_rglru.rglru_forward(jp, jx[:, t:t + 1], state=js, return_state=True)
        to, ts = t_rglru.rglru_forward(tp, tx[:, t:t + 1], state=ts, return_state=True)
        _close(to, jo, tol, f"decode {t}")
    assert ts.conv.dtype == getattr(torch, dtype)


# -- the FT trainer on the recurrentgemma smoke -------------------------------------


def _kw(**kw):
    base = dict(steps=2, lr=1e-2, warmup=0, n_lanes=4, diskless_every=2,
                log_every=100, optimizer="caqr_muon")
    base.update(kw)
    return base


JD = JDataConfig(vocab=256, seq_len=32, global_batch=8, seed=1)
TD = DataConfig(vocab=256, seq_len=32, global_batch=8, seed=1)
# step 1, the second group's LRU in-projection, after panel 2's first
# butterfly level
KILL = dict(at_step=1, lane=1, task="groups/l0/lru/.w_in#1", point=(2, "tsqr", 1))


def _port(**kw):
    return T.FTTrainer(get_smoke(ARCH), TrainConfig(semantics=Semantics.REBUILD,
                                                    **_kw()), TD, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's trainer: the state it starts from, its first step's metrics
    and the state after it."""
    jt = J.FTTrainer(j_get_smoke(ARCH), JTrainConfig(semantics=JSemantics.REBUILD,
                                                      **_kw()), JD)
    entry = jt.state
    tasks = [(t.name, t.rows, t.cols, t.transpose) for t in jt._tasks]
    m = jt._execute_step(0, jt._lane_batch(0))
    return dict(entry=entry, metrics=m, after=jt.state, tasks=tasks)


def test_one_ft_step_from_jax_state_within_tolerance(jax_step):
    tr = _port()
    assert [(t.name, t.rows, t.cols, t.transpose) for t in tr._tasks] == jax_step["tasks"]
    js = jax_step["entry"]
    params = interop.params_from_arrays(j_save._flatten(js.params), get_smoke(ARCH),
                                        device="cpu")
    opt = interop.opt_state_from_arrays(j_save._flatten(js.opt_state), params,
                                        "caqr_muon")
    tr.state = TrainState(params, opt, torch.tensor(int(js.step), dtype=torch.int32))
    m = tr._execute_step(0, tr._lane_batch(0))
    for key in ("loss", "lr", "gnorm"):
        np.testing.assert_allclose(float(m[key]), float(jax_step["metrics"][key]),
                                   rtol=RTOL, atol=ATOL)
    want = jax_step["after"]
    for got, w in ((tr.state.params, want.params), (tr.state.opt_state, want.opt_state)):
        wf, gf = j_save._flatten(w), interop.params_to_arrays(got)
        assert list(gf) == list(wf)
        for path in wf:
            np.testing.assert_allclose(gf[path], wf[path], rtol=RTOL, atol=ATOL,
                                       err_msg=path)
    assert tr.engine.sweeps == len(jax_step["tasks"])


def test_kill_inside_a_sweep_equals_failure_free():
    ref = _port()
    hist_ref = ref.run()
    killer = T.StepSweepKiller(**KILL)
    tr = _port(qr_fault_hooks=[killer])
    hist = tr.run()
    ev = tr.engine.events
    assert killer.struck[:2] == (KILL["at_step"], KILL["task"])
    assert len(ev) == 1 and ev[0].lane == KILL["lane"]
    assert ev[0].reads and KILL["lane"] not in ev[0].reads.values()
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_ref]
    assert all(np.isfinite(h["loss"]) for h in hist)
    for a, b in ((tr.state.params, ref.state.params),
                 (tr.state.opt_state, ref.state.opt_state)):
        assert all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


def test_launcher_trains_on_cpu(capsys):
    from repro_torch.launch import train as t_launch

    t_launch.main(["--arch", ARCH, "--device", "cpu", "--optimizer", "caqr_muon",
                   "--steps", "2", "--global-batch", "8", "--seq-len", "32"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "nan" not in out
