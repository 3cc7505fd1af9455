"""The port's Mamba2 SSD block (``repro_torch.models.ssm``) and the mamba2
family against the JAX package's, on CPU tensors.

Against JAX, on the same numpy-seeded inputs: ``ssd_chunked`` at chunk 8,
with and without a carried state, the outputs and the gradients of a
weighted sum within the f32 pair of ``repro.kernels.ref.tolerances``;
``ssm_forward`` without a state, and a prefill that returns its state
followed by S = 1 decode steps on it, the outputs and the states, at f32
and at bf16 (the bf16 pair); one ``FTTrainer`` step (``caqr_muon``) of the
mamba2 smoke from JAX's carried state: the metrics, params and optimizer
state. The reference's fault: at chunk 64 JAX's gradient with respect to
dt is not finite (its decay kernel ``where(tri, exp(diff), 0)`` overflows
above the diagonal), while the port's is finite and within 1e-3 of a
float64 sequential recurrence written here. The smoke's own chunk of 8
already overflows there (exp's argument reaches 7 * 16 * dt, above 88 for
dt > 0.79, and the init's dt reaches 0.97): JAX's mamba2 smoke has NaN in
every gradient leaf, so its trainer is run at chunk 4 (the same function,
chunked otherwise), the port's at the smoke's 8. Inside the port,
bitwise: a lane killed inside a sweep heals to the failure-free run.
"""
import dataclasses

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
from repro.models import ssm as j_ssm
from repro.train import ftrun as J
from repro.train.loop import TrainConfig as JTrainConfig
from repro_torch import interop, tree
from repro_torch.configs import get_smoke
from repro_torch.configs.base import SSMConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.semantics import Semantics
from repro_torch.models import ssm as t_ssm
from repro_torch.train import TrainConfig, TrainState
from repro_torch.train import ftrun as T

RTOL, ATOL = tolerances(np.float32)
ARCH = "mamba2-2.7b"
SSM = SSMConfig(d_state=8, expand=2, head_dim=8, n_groups=2, chunk=8)
D = 16


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


def _ssd_inputs(rng, B=2, S=16, H=4, P=4, G=2, N=8):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    # dt small enough that the reference's decay kernel does not overflow
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 2.0)).astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero-state", "carried-state"])
def test_ssd_chunked_and_its_gradients_match_jax(rng, with_h0):
    x, dt, A, Bm, Cm = _ssd_inputs(rng)
    h0 = rng.standard_normal((2, 4, 4, 8)).astype(np.float32) if with_h0 else None
    wy = rng.standard_normal(x.shape).astype(np.float32)
    wh = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)

    def j_loss(x, dt, Bm, Cm):
        y, h = j_ssm.ssd_chunked(x, dt, jnp.asarray(A), Bm, Cm, 8,
                                 None if h0 is None else jnp.asarray(h0))
        return jnp.sum(y * wy) + jnp.sum(h * wh), (y, h)

    (_, (jy, jh)), jg = jax.value_and_grad(j_loss, argnums=(0, 1, 2, 3), has_aux=True)(
        *map(jnp.asarray, (x, dt, Bm, Cm)))
    ins = [torch.from_numpy(a).requires_grad_(True) for a in (x, dt, Bm, Cm)]
    ty, th = t_ssm.ssd_chunked(ins[0], ins[1], torch.from_numpy(A), ins[2], ins[3], 8,
                               None if h0 is None else torch.from_numpy(h0))
    (torch.sum(ty * torch.from_numpy(wy)) + torch.sum(th * torch.from_numpy(wh))).backward()
    for got, want, name in ((ty, jy, "y"), (th, jh, "h")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    for t, g, name in zip(ins, jg, ("x", "dt", "B", "C")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=RTOL, atol=ATOL,
                                   err_msg=f"d{name}")


def _ssm_params(rng):
    d_inner, H, _, G, N = t_ssm._dims(D, SSM)
    conv_dim = d_inner + 2 * G * N
    arrays = dict(
        w_in=rng.standard_normal((D, 2 * d_inner + 2 * G * N + H)) * 0.2,
        conv_w=rng.standard_normal((SSM.conv_width, conv_dim)) * 0.3,
        A_log=np.log(np.linspace(1.0, 16.0, H)),
        Dskip=np.ones(H), dt_bias=rng.standard_normal(H) * 0.3,
        norm_scale=rng.standard_normal(d_inner) * 0.1,
        w_out=rng.standard_normal((d_inner, D)) * 0.2)
    return {k: v.astype(np.float32) for k, v in arrays.items()}


def _as(arrays, cls, lib, dtype):
    """``cls`` of JAX (lib jnp) or torch tensors: float32 leaves named in
    the reference as float32 stay so, the rest in ``dtype``."""
    f32 = ("A_log", "Dskip", "dt_bias", "a_param")
    if lib is jnp:
        return cls(**{k: jnp.asarray(v, jnp.float32 if k in f32 else dtype)
                      for k, v in arrays.items()})
    return cls(**{k: torch.from_numpy(v).to(torch.float32 if k in f32 else dtype)
                  for k, v in arrays.items()})


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1], err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_forward_prefill_and_decode_match_jax(rng, dtype):
    """No state (S = 16, two chunks), then a prefill of 16 that returns its
    state and 3 decode steps (S = 1, the recurrence's fast path) on it."""
    tol = tolerances(np.float32 if dtype == "float32" else jnp.bfloat16)
    arrays = _ssm_params(rng)
    jp = _as(arrays, j_ssm.SSMParams, jnp, getattr(jnp, dtype))
    tp = _as(arrays, t_ssm.SSMParams, torch, getattr(torch, dtype))
    x = rng.standard_normal((2, 19, D)).astype(np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    kw = dict(d_model=D, ssm_cfg=SSM)
    want = j_ssm.ssm_forward(jp, jx[:, :16], **kw)
    _close(t_ssm.ssm_forward(tp, tx[:, :16], **kw), want, tol, "no state")
    jo, js = j_ssm.ssm_forward(jp, jx[:, :16], return_state=True, **kw)
    to, ts = t_ssm.ssm_forward(tp, tx[:, :16], return_state=True, **kw)
    _close(to, jo, tol, "prefill")
    for t in range(16, 19):
        _close(ts.h, js.h, tol, f"h before {t}")
        _close(ts.conv, js.conv, tol, f"conv before {t}")
        jo, js = j_ssm.ssm_forward(jp, jx[:, t:t + 1], state=js, return_state=True, **kw)
        to, ts = t_ssm.ssm_forward(tp, tx[:, t:t + 1], state=ts, return_state=True, **kw)
        _close(to, jo, tol, f"decode {t}")
    assert ts.h.dtype == torch.float32 and ts.conv.dtype == getattr(torch, dtype)


def test_ssm_forward_raises_on_a_partial_chunk(rng):
    tp = _as(_ssm_params(rng), t_ssm.SSMParams, torch, torch.float32)
    with pytest.raises(ValueError, match="not a multiple"):
        t_ssm.ssm_forward(tp, torch.zeros(1, 12, D), d_model=D, ssm_cfg=SSM)


def _sequential_f64(x, dt, A, Bm, Cm, rep):
    """y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T, one
    step at a time in float64 (the recurrence SSD computes in chunks)."""
    B, S, H, P = x.shape
    Bh = torch.repeat_interleave(Bm, rep, dim=2)
    Ch = torch.repeat_interleave(Cm, rep, dim=2)
    h = torch.zeros(B, H, P, Bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(S):
        h = (torch.exp(dt[:, t] * A)[:, :, None, None] * h
             + dt[:, t][:, :, None, None] * x[:, t][..., None] * Bh[:, t][:, :, None, :])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], h))
    return torch.stack(ys, dim=1)


def test_ssd_gradient_finite_where_the_reference_overflows(rng):
    """B = 1, S = 512, H = 4, A_log from the init (log 1 .. log 16), dt =
    softplus(0): at chunk 64 exp(cums[s] - cums[t]) above the diagonal
    overflows float32, and the reference's gradient with respect to dt
    holds NaN; the port's is finite and within 1e-3 (relative to its
    largest entry) of float64's. At chunk 8 both packages agree."""
    B, S, H, P, G, N = 1, 512, 4, 4, 1, 8
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    dt = np.full((B, S, H), np.log(2.0), np.float32)
    wy = rng.standard_normal(x.shape).astype(np.float32)

    def j_grad(chunk):
        def loss(dt):
            y, _ = j_ssm.ssd_chunked(jnp.asarray(x), dt, jnp.asarray(A), jnp.asarray(Bm),
                                     jnp.asarray(Cm), chunk)
            return jnp.sum(y * wy)
        return np.asarray(jax.grad(loss)(jnp.asarray(dt)))

    def t_grad(chunk):
        d = torch.from_numpy(dt.copy()).requires_grad_(True)
        y, _ = t_ssm.ssd_chunked(torch.from_numpy(x), d, torch.from_numpy(A),
                                 torch.from_numpy(Bm), torch.from_numpy(Cm), chunk)
        torch.sum(y * torch.from_numpy(wy)).backward()
        return d.grad.numpy()

    d64 = torch.from_numpy(dt).double().requires_grad_(True)
    y64 = _sequential_f64(torch.from_numpy(x).double(), d64, torch.from_numpy(A).double(),
                          torch.from_numpy(Bm).double(), torch.from_numpy(Cm).double(), H // G)
    torch.sum(y64 * torch.from_numpy(wy).double()).backward()
    want = d64.grad.numpy()
    scale = np.abs(want).max()
    assert not np.isfinite(j_grad(64)).all()
    got = t_grad(64)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-3 * scale, np.abs(got - want).max() / scale
    jg8, tg8 = j_grad(8), t_grad(8)
    assert np.isfinite(jg8).all()
    np.testing.assert_allclose(tg8, jg8, rtol=RTOL, atol=RTOL * scale)
    assert np.abs(tg8 - want).max() <= 1e-3 * scale


# -- the FT trainer on the mamba2 smoke -------------------------------------------


def _kw(**kw):
    base = dict(steps=2, lr=1e-2, warmup=0, n_lanes=4, diskless_every=2,
                log_every=100, optimizer="caqr_muon")
    base.update(kw)
    return base


JD = JDataConfig(vocab=256, seq_len=32, global_batch=8, seed=1)
TD = DataConfig(vocab=256, seq_len=32, global_batch=8, seed=1)
# step 1, the second w_in slice, after panel 2's first butterfly level
KILL = dict(at_step=1, lane=1, task="groups/l0/ssm/.w_in#1", point=(2, "tsqr", 1))


def j_smoke():
    """JAX's mamba2 smoke at chunk 4, where its gradients are finite."""
    cfg = j_get_smoke(ARCH)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=4))


def _port(**kw):
    return T.FTTrainer(get_smoke(ARCH), TrainConfig(semantics=Semantics.REBUILD,
                                                    **_kw()), TD, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's trainer: the state it starts from, its first step's metrics
    and the state after it."""
    jt = J.FTTrainer(j_smoke(), JTrainConfig(semantics=JSemantics.REBUILD,
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
