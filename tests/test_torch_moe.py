"""The port's MoE family (``repro_torch.models.moe``, the transformer's 'L'
and 'E' layers, the ``mixtral-8x22b`` and ``kimi-k2-1t-a32b`` configs)
and the dense ``gemma-7b`` and ``nemotron-4-340b`` configs against the JAX
package's, on CPU tensors (f32).

Exactly: routing (expert ids, each assignment's slot in its expert's
buffer, which assignments are kept at capacity), with an overflowing
expert and with exact ties in the router's probabilities; parameter paths,
shapes and dtypes (the router float32), at smoke size and at the
published widths; the FT trainer's task plan, its engine's sweeps,
boundaries and segments and ``StepSweepKiller.struck``. Within the f32
pair of ``repro.kernels.ref.tolerances``: ``moe_forward``'s output and aux
loss, and with JAX's parameters carried across the loss and every
gradient leaf (mixtral's window is exercised: sequence 32 over a window of
16), and one ``FTTrainer`` step from JAX's carried state. Inside the port,
bitwise: remat changes no value, and a lane killed inside an expert-bank
sweep heals to the failure-free run's params and losses.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ckpt import save as j_save
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke as j_get_smoke
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch
from repro.ft.semantics import Semantics as JSemantics
from repro.kernels.ref import tolerances
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro.train import ftrun as J
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.step import make_loss_and_grads as j_loss_and_grads
from repro_torch import interop, tree
from repro_torch.configs import get_config, get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.semantics import Semantics
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.train import TrainConfig, TrainState
from repro_torch.train import ftrun as T
from repro_torch.train.step import make_loss_and_grads

RTOL, ATOL = tolerances(np.float32)
MOE_ARCHS = ("mixtral-8x22b", "kimi-k2-1t-a32b")
DENSE_ARCHS = ("gemma-7b", "nemotron-4-340b")
FT_ARCH = "mixtral-8x22b"
ROUTER = "groups/l0/ffn/.w_router"
# the kill inside an expert-bank sweep: step 1, the fourth w_gate slice, at
# a mid-sweep point (panel 2 of 4, after butterfly level 1), where the
# REBUILD reads the dead lane's artifacts from a buddy
KILL = dict(at_step=1, lane=1, task="groups/l0/ffn/.w_gate#3", point=(2, "tsqr", 1))


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while this module runs: the port's
    trainers run many small ops, and with several test processes on one
    host, each op's thread team spins against the other processes'
    threads (six processes of eight threads ran a 2-step trainer 50x
    slower than with one thread each). The results are compared run
    against run inside the module, all under the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- routing -------------------------------------------------------------------


def _jax_routing(w_router, x, top_k, capacity_factor):
    """The routing lines of the reference's ``_moe_group`` on tokens ``x
    (N, D)``: (expert ids (N, K), sorted expert, sorted token,
    pos_in_expert, keep)."""
    logits = jnp.asarray(x, jnp.float32) @ jnp.asarray(w_router, jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, expert_ids = jax.lax.top_k(probs, top_k)
    N, E = probs.shape
    C = max(int(capacity_factor * N * top_k / E), 8)
    flat_expert = expert_ids.reshape(-1)
    flat_token = jnp.repeat(jnp.arange(N), top_k)
    order = jnp.argsort(flat_expert)
    sorted_expert = flat_expert[order]
    seg_start = jnp.searchsorted(sorted_expert, jnp.arange(E), side="left")
    pos = jnp.arange(N * top_k) - seg_start[sorted_expert]
    return tuple(np.asarray(a) for a in (expert_ids, sorted_expert,
                                         flat_token[order], pos, pos < C))


def _port_routing(w_router, x, top_k, capacity_factor):
    p = t_moe.MoEParams(torch.from_numpy(w_router), None, None, None)
    probs = t_moe.router_probs(p, torch.from_numpy(x))
    r, ids = t_moe.route(probs, top_k, capacity_factor)
    return tuple(a.numpy() for a in (ids, r.expert, r.token, r.pos, r.keep))


def _moe_params(rng, D, E, F, scale=0.2):
    return [rng.standard_normal(s).astype(np.float32) * scale
            for s in ((D, E), (E, D, F), (E, D, F), (E, F, D))]


def _both_forwards(ws, x, **kw):
    jo, ja = j_moe.moe_forward(j_moe.MoEParams(*map(jnp.asarray, ws)),
                               jnp.asarray(x), **kw)
    to, ta = t_moe.moe_forward(t_moe.MoEParams(*map(torch.from_numpy, ws)),
                               torch.from_numpy(x), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=RTOL, atol=ATOL)
    return to


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "sq_relu"])
@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_and_routing_match_jax(rng, arch, shards, activation):
    cfg = get_smoke(arch)
    m = cfg.moe
    B, S, D = 4, 32, cfg.d_model
    ws = _moe_params(rng, D, m.n_experts, m.d_ff_expert)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    _both_forwards(ws, x, top_k=m.top_k, capacity_factor=m.capacity_factor,
                   activation=activation, shards=shards)
    for xs in x.reshape(shards, B * S // shards, D):
        want = _jax_routing(ws[0], xs, m.top_k, m.capacity_factor)
        got = _port_routing(ws[0], xs, m.top_k, m.capacity_factor)
        for name, g, w in zip(("ids", "expert", "token", "pos", "keep"), got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_overflowing_expert_drops_the_same_tokens(rng):
    """Expert 0 is every token's first choice: 128 assignments against a
    capacity of 80, so 48 are dropped, the same ones in both packages."""
    N, D, E, F, K = 128, 16, 4, 8, 2
    ws = _moe_params(rng, D, E, F)
    x = rng.standard_normal((1, N, D)).astype(np.float32)
    x[..., 0] = 1.0 + np.abs(x[..., 0])
    # a logit margin of about 8: large enough for expert 0 to win every
    # token, small enough that no probability is subnormal (XLA's CPU code
    # flushes subnormals to zero and torch's does not)
    ws[0][:, 0] = 0.0
    ws[0][0, 0] = 8.0
    want = _jax_routing(ws[0], x[0], K, 1.25)
    got = _port_routing(ws[0], x[0], K, 1.25)
    assert (want[0][:, 0] == 0).all() and t_moe.capacity(N, K, E, 1.25) == 80
    assert int((~want[4]).sum()) == 48 and (want[1][~want[4]] == 0).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _both_forwards(ws, x, top_k=K, capacity_factor=1.25)


@pytest.mark.parametrize("case", ["all_equal", "two_columns_equal"])
def test_exact_ties_break_toward_the_lower_expert(rng, case):
    N, D, E, F = 32, 16, 4, 8
    ws = _moe_params(rng, D, E, F)
    x = rng.standard_normal((1, N, D)).astype(np.float32)
    if case == "all_equal":
        ws[0][:] = 0.0           # every probability is 1/E
        top_k = 2
    else:
        ws[0][:, 1] = ws[0][:, 2] = np.abs(ws[0][:, 1]) * 4
        x = np.abs(x)            # experts 1 and 2 tie at the top
        top_k = 1
    want = _jax_routing(ws[0], x[0], top_k, 1.25)
    got = _port_routing(ws[0], x[0], top_k, 1.25)
    if case == "all_equal":
        assert (want[0] == [0, 1]).all()
    else:
        assert (want[0][:, 0] == 1).all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    _both_forwards(ws, x, top_k=top_k, capacity_factor=1.25)


# -- parameters ------------------------------------------------------------------


@pytest.mark.parametrize("arch", MOE_ARCHS + DENSE_ARCHS)
def test_init_paths_shapes_and_dtypes_equal_jax(arch):
    jp = j_tf.init_params(j_get_smoke(arch), jax.random.key(0))
    want = [(k, v.shape, str(v.dtype)) for k, v in j_save._flatten(jp).items()]
    for params in (t_tf.init_params(get_smoke(arch), torch.Generator().manual_seed(0)),
                   t_tf.param_template(get_smoke(arch))):
        got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
               for p, x in tree.flatten_with_path(params)]
        assert got == want
    if arch in MOE_ARCHS:
        assert dict((k, d) for k, _, d in want)["groups/l0/ffn/.w_router"] == "float32"


@pytest.mark.parametrize("arch", MOE_ARCHS + DENSE_ARCHS)
def test_full_width_template_matches_published_shapes(arch):
    abstract = jax.eval_shape(lambda k: j_tf.init_params(j_get_config(arch), k),
                              jax.random.key(0))
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
             tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]]
    got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in tree.flatten_with_path(t_tf.param_template(get_config(arch)))]
    assert got == want
    by_path = {p: (s, d) for p, s, d in got}
    if arch == "mixtral-8x22b":
        assert by_path["groups/l0/ffn/.w_gate"] == ((56, 8, 6144, 16384), "bfloat16")
        assert by_path["groups/l0/ffn/.w_out"] == ((56, 8, 16384, 6144), "bfloat16")
        assert by_path["groups/l0/ffn/.w_router"] == ((56, 6144, 8), "float32")
        assert by_path["groups/l0/attn/.wk"][0] == (56, 6144, 1024)
    elif arch == "kimi-k2-1t-a32b":
        assert by_path["groups/l0/ffn/.w_in"][0] == (61, 384, 7168, 2048)
    elif arch == "gemma-7b":
        assert "lm_head" not in by_path and by_path["embed"][0] == (256000, 3072)
        assert by_path["groups/l0/attn/.wq"][0] == (28, 3072, 4096)
    else:
        assert by_path["groups/l0/ffn/.w_gate"][0] == (96, 1, 1)


# -- loss and gradients ----------------------------------------------------------


def _batch(cfg, step=0):
    dcfg = JDataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=1)
    return make_batch(dcfg, step)


@pytest.mark.parametrize("arch,overrides", [
    ("mixtral-8x22b", {}), ("mixtral-8x22b", {"moe_shards": 2}),
    ("kimi-k2-1t-a32b", {}), ("gemma-7b", {}), ("nemotron-4-340b", {}),
], ids=["mixtral", "mixtral-shards2", "kimi", "gemma", "nemotron"])
def test_loss_and_every_gradient_leaf_within_tolerance(arch, overrides):
    jcfg = dataclasses.replace(j_get_smoke(arch), **overrides)
    tcfg = dataclasses.replace(get_smoke(arch), **overrides)
    jp = j_tf.init_params(jcfg, jax.random.key(0))
    batch = _batch(jcfg)
    jl, jg = jax.jit(j_loss_and_grads(jcfg))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = interop.params_from_arrays(j_save._flatten(jp), tcfg, device="cpu")
    tl, tg = make_loss_and_grads(tcfg)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    want = j_save._flatten(jg)
    got = dict(tree.flatten_with_path(tg))
    assert list(got) == list(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path].numpy(), g, rtol=RTOL, atol=ATOL,
                                   err_msg=path)
    if "ffn/.w_router" in "".join(want):
        # the aux loss reaches the router
        assert np.abs(want["groups/l0/ffn/.w_router"]).max() > 0


def test_window_and_aux_loss_are_applied():
    """Mixtral's smoke window (16) masks at sequence 32, and the loss holds
    the layers' aux losses: dropping either changes the loss."""
    cfg = get_smoke(FT_ARCH)
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    loss, parts = t_tf.loss_fn(cfg, params, batch)
    assert float(parts["aux"]) > 0
    torch.testing.assert_close(loss, parts["ce"] + 0.01 * parts["aux"], rtol=0, atol=0)
    wide, _ = t_tf.loss_fn(dataclasses.replace(cfg, sliding_window=10 ** 6),
                           params, batch)
    assert float(wide) != float(loss)


def test_remat_changes_no_value():
    cfg = get_smoke(FT_ARCH)
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(1))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
    la, ga = make_loss_and_grads(cfg)(params, batch)
    lb, gb = make_loss_and_grads(dataclasses.replace(cfg, remat="none"))(params, batch)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(ga), tree.leaves(gb)))


# -- the FT trainer ---------------------------------------------------------------


def _kw(**kw):
    base = dict(steps=2, lr=1e-2, warmup=2, n_lanes=4, diskless_every=2,
                log_every=100, optimizer="caqr_muon")
    base.update(kw)
    return base


JD = JDataConfig(vocab=256, seq_len=32, global_batch=8, seed=1)
TD = DataConfig(vocab=256, seq_len=32, global_batch=8, seed=1)


def _stats(engine):
    return (engine.sweeps, engine.boundaries, engine.segments)


def _port(**kw):
    return T.FTTrainer(get_smoke(FT_ARCH), TrainConfig(semantics=Semantics.REBUILD,
                                                       **_kw()),
                       TD, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's failure-free run driven step by step (the state entering step 1
    and after it, the metrics, the engine's stats), and its run with lane 1
    killed inside the fourth w_gate sweep of step 1."""
    jt = J.FTTrainer(j_get_smoke(FT_ARCH),
                     JTrainConfig(semantics=JSemantics.REBUILD, **_kw()), JD)
    out = {"tasks": [(t.name, t.path, t.index, t.rows, t.cols, t.transpose)
                     for t in jt._tasks]}
    for s in range(2):
        if s == 1:
            out["entry1"] = jt.state
        m = jt._execute_step(s, jt._lane_batch(s))
        if s == 1:
            out["after1"], out["metrics1"] = jt.state, m
    out["stats"] = _stats(jt.engine)
    killer = J.StepSweepKiller(**KILL)
    jk = J.FTTrainer(j_get_smoke(FT_ARCH),
                     JTrainConfig(semantics=JSemantics.REBUILD, **_kw()), JD,
                     qr_fault_hooks=[killer])
    jk.run()
    out["struck"], out["kill_stats"] = killer.struck, _stats(jk.engine)
    return out


@pytest.fixture(scope="module")
def port_ff():
    tr = _port()
    return tr, tr.run()


def test_ft_plan_stats_and_struck_equal_jax(jax_run, port_ff):
    tr, _ = port_ff
    got = [(t.name, t.path, t.index, t.rows, t.cols, t.transpose) for t in tr._tasks]
    assert got == jax_run["tasks"]
    assert len(got) == 24 and got[0][0] == "groups/l0/ffn/.w_gate#0"
    assert [t[0] for t in got[8:10]] == ["groups/l0/ffn/.w_in#0", "groups/l0/ffn/.w_in#1"]
    assert {(t[3], t[4], t[5]) for t in got} == {(128, 64, True), (128, 64, False)}
    assert _stats(tr.engine) == jax_run["stats"] == (48, 960, 960)
    killer = T.StepSweepKiller(**KILL)
    tk = _port(qr_fault_hooks=[killer])
    tk.run()
    assert killer.struck == jax_run["struck"]
    assert killer.struck[:2] == (KILL["at_step"], KILL["task"])
    assert _stats(tk.engine) == jax_run["kill_stats"]


def test_one_ft_step_from_jax_state_within_tolerance(jax_run):
    tr = _port()
    js = jax_run["entry1"]
    params = interop.params_from_arrays(j_save._flatten(js.params),
                                        get_smoke(FT_ARCH), device="cpu")
    opt = interop.opt_state_from_arrays(j_save._flatten(js.opt_state), params,
                                        "caqr_muon")
    tr.state = TrainState(params, opt, torch.tensor(int(js.step), dtype=torch.int32))
    m = tr._execute_step(1, tr._lane_batch(1))
    for key in ("loss", "lr", "gnorm"):
        np.testing.assert_allclose(float(m[key]), float(jax_run["metrics1"][key]),
                                   rtol=RTOL, atol=ATOL)
    want = jax_run["after1"]
    assert int(tr.state.step) == int(want.step) == 2
    E = get_smoke(FT_ARCH).moe.n_experts
    for got, w in ((tr.state.params, want.params), (tr.state.opt_state, want.opt_state)):
        wf, gf = j_save._flatten(w), interop.params_to_arrays(got)
        assert list(gf) == list(wf)
        for path in wf:
            g, x = gf[path], wf[path]
            if path == ROUTER and w is want.params:
                # the router's momentum has rank E-1: softmax's logit
                # gradients sum to zero over the experts, so its columns do
                # too, and the last column of its Muon Q (so of the update)
                # is round-off in either package. The other E-1 are held.
                mom = j_save._flatten(want.opt_state)[".mom/" + ROUTER]
                assert np.abs(mom.sum(-1)).max() < 1e-6 * np.abs(mom).max()
                g, x = g[..., :E - 1], x[..., :E - 1]
            np.testing.assert_allclose(g, x, rtol=RTOL, atol=ATOL, err_msg=path)
    assert tr.engine.sweeps == 24


def test_expert_bank_kill_equals_failure_free(port_ff):
    ref, hist_ref = port_ff
    killer = T.StepSweepKiller(**KILL)
    tr = _port(qr_fault_hooks=[killer])
    hist = tr.run()
    ev = tr.engine.events
    assert len(ev) == 1 and ev[0].lane == KILL["lane"]
    assert ev[0].reads and KILL["lane"] not in ev[0].reads.values()
    assert [h["step"] for h in hist] == [0, 1]
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_ref]
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(tr.state.params), tree.leaves(ref.state.params)))
    assert all(torch.equal(a, b) for a, b in
               zip(tree.leaves(tr.state.opt_state), tree.leaves(ref.state.opt_state)))


def test_launcher_trains_mixtral_on_cpu(capsys):
    from repro_torch.launch import train as t_launch

    t_launch.main(["--arch", FT_ARCH, "--device", "cpu", "--optimizer", "caqr_muon",
                   "--steps", "2", "--global-batch", "8", "--seq-len", "32"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out
