"""The port's FT training runtime (``repro_torch.train.ftrun``) against the
JAX package's, CPU tensors, at the geometry of ``tests/test_ftrun.py``:
the ``tinyllama`` smoke config (f32), DataConfig seq 32 / batch 8, 4
lanes, panel width 16 (every routed FFN slice is a (128, 64) sweep; the
attention leaves stay below ``min_qr_size`` on ``_orth``).

Exactly: the Muon and PowerSGD task plans (names, rows, cols,
transpose), the engine's stats (sweeps, boundaries, segments) and
``StepSweepKiller.struck``. Within the f32 pair of
``repro.kernels.ref.tolerances``: one ``FTTrainer`` step from JAX's
carried state, for ``caqr_muon`` and for the PowerSGD bridge (whose
error buffers and sketches are carried too), and the engine's Q (within
the tolerance times cond(M): Q = M R^-1 amplifies R's last bits by
cond(R) = cond(M)). A JAX-written wire-v2 sweep state, suspended inside
the last step, resumes in the port's ``FTTrainer.resume`` within
tolerance of JAX's uninterrupted run. Inside the port, bitwise: kill ==
failure-free, async == sync, suspend/resume == uninterrupted,
PowerSGD-bridge kill == failure-free, ``mds_f=2`` with two deaths at one
boundary == failure-free.

The JAX trainers run once each, in module-scoped fixtures.
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
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train import ftrun as J
from repro_torch import interop, tree
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.online.detect import ScriptedKiller
from repro_torch.ft.semantics import Semantics
from repro_torch.launch import spmd_qr
from repro_torch.models import transformer as t_tf
from repro_torch.train import TrainConfig, TrainState
from repro_torch.train import ftrun as T

RTOL, ATOL = tolerances(np.float32)
ARCH = "tinyllama-1.1b"
# cumulative boundaries: 6 sweeps of 20 boundaries a step, so 290 falls in
# step 2's third sweep and 411 in step 3's third
SUSPEND_PORT, SUSPEND_JAX = 290, 411
MDS_POINT = (1, "tsqr", 0)


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


def _kw(**kw):
    base = dict(steps=4, lr=1e-2, warmup=2, n_lanes=4, diskless_every=2,
                log_every=100)
    base.update(kw)
    return base


def _jt(**kw):
    return JTrainConfig(**_kw(semantics=JSemantics.REBUILD, **kw))


def _tt(**kw):
    return TrainConfig(**_kw(semantics=Semantics.REBUILD, **kw))


JD = JDataConfig(vocab=256, seq_len=32, global_batch=8, seed=1)
TD = DataConfig(vocab=256, seq_len=32, global_batch=8, seed=1)


def _port(**kw):
    return T.FTTrainer(get_smoke(ARCH), device="cpu", dcfg=TD, **kw)


def _stats(engine):
    return (engine.sweeps, engine.boundaries, engine.segments)


def _carry(jstate, like: TrainState) -> TrainState:
    params = interop.params_from_arrays(j_save._flatten(jstate.params),
                                        get_smoke(ARCH), device="cpu")
    opt = interop.opt_state_from_arrays(
        j_save._flatten(jstate.opt_state), params,
        "caqr_muon" if hasattr(jstate.opt_state, "mom") else "adamw")
    assert type(opt) is type(like.opt_state)
    return TrainState(params, opt, torch.tensor(int(jstate.step), dtype=torch.int32))


def _close_tree(got, want, atol=ATOL):
    w = j_save._flatten(want)
    g = interop.params_to_arrays(got)
    assert list(g) == list(w)
    for path in w:
        np.testing.assert_allclose(g[path], w[path], rtol=RTOL, atol=atol, err_msg=path)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


# -- the JAX runs ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_muon():
    """JAX's failure-free caqr_muon run, driven step by step: the state
    entering step 2 and after it, the metrics, the final state and the
    engine's stats."""
    jt = J.FTTrainer(j_get_smoke(ARCH), _jt(optimizer="caqr_muon"), JD)
    out = {"losses": []}
    for s in range(4):
        if s == 2:
            out["entry2"] = jt.state
        m = jt._execute_step(s, jt._lane_batch(s))
        out["losses"].append(float(m["loss"]))
        if s == 2:
            out["after2"], out["metrics2"] = jt.state, m
    out["final"], out["stats"] = jt.state, _stats(jt.engine)
    return out


@pytest.fixture(scope="module")
def jax_kill():
    killer = J.StepSweepKiller(at_step=2, lane=1)
    jt = J.FTTrainer(j_get_smoke(ARCH), _jt(optimizer="caqr_muon"), JD,
                     qr_fault_hooks=[killer])
    jt.run()
    return killer.struck, _stats(jt.engine)


@pytest.fixture(scope="module")
def jax_psgd():
    """JAX's PowerSGD bridge: its state and bridge buffers entering step 1,
    and after it."""
    jt = J.FTTrainer(j_get_smoke(ARCH), _jt(optimizer="adamw", steps=2), JD,
                     J.FTRunConfig(compression_rank=4, compression_min_size=4096))
    jt._execute_step(0, jt._lane_batch(0))
    entry = jt.state
    psgd = {k: dict(v) for k, v in jt._psgd.items()}
    m = jt._execute_step(1, jt._lane_batch(1))
    return dict(entry=entry, psgd=psgd, after=jt.state, metrics=m,
                after_psgd=jt._psgd, tasks=jt._tasks)


@pytest.fixture(scope="module")
def jax_suspended(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax_suspend"))
    jt = J.FTTrainer(j_get_smoke(ARCH), _jt(optimizer="caqr_muon", ckpt_dir=d), JD,
                     J.FTRunConfig(suspend_after_boundaries=SUSPEND_JAX))
    with pytest.raises(J.TrainingSuspended) as exc:
        jt.run()
    return d, exc.value


@pytest.fixture(scope="module")
def lane_group():
    g = spmd_qr.make_lane_group(4, device="cpu", timeout_s=60.0)
    yield g
    g.close()
    assert not any(p.is_alive() for p in g._procs)


@pytest.fixture(scope="module")
def mesh_runs(lane_group):
    """The mesh trainer over the group's four ranks, 3 steps, failure-free
    and with lane 3 killed inside step 1's first sweep, and the SimComm
    trainer at the same lane count: the port's counterpart of
    ``tests/test_spmd_bigp.py``'s ``_FTRUN_TRAIN_BODY``."""
    mesh = spmd_qr.make_lane_mesh(4, device="cpu", group=lane_group)
    tcfg = _tt(optimizer="caqr_muon", steps=3)
    out = {}
    ref = _port(tcfg=tcfg, fcfg=T.FTRunConfig(use_mesh=True, qr_lanes=4), mesh=mesh)
    out["ff"] = (ref, ref.run())
    killer = T.StepSweepKiller(at_step=1, lane=3)
    tr = _port(tcfg=tcfg, fcfg=T.FTRunConfig(use_mesh=True, qr_lanes=4), mesh=mesh,
               qr_fault_hooks=[killer])
    out["kill"] = (tr, tr.run(), killer)
    sim = _port(tcfg=tcfg, fcfg=T.FTRunConfig(qr_lanes=4))
    out["sim"] = (sim, sim.run())
    return out


@pytest.fixture(scope="module")
def port_ff():
    tr = _port(tcfg=_tt(optimizer="caqr_muon"))
    hist = tr.run()
    return tr, hist


@pytest.fixture(scope="module")
def port_psgd_ff():
    tr = _port(tcfg=_tt(optimizer="adamw", steps=2),
               fcfg=T.FTRunConfig(compression_rank=4, compression_min_size=4096))
    return tr, tr.run()


# -- plans and the engine ----------------------------------------------------


@pytest.mark.parametrize("min_size", [8192, 4096, 1024])
def test_task_plans_equal_jax(jax_muon, min_size):
    jp = jax_muon["final"].params
    tp = t_tf.param_template(get_smoke(ARCH))
    for jplan, tplan in ((J.plan_muon_tasks, T.plan_muon_tasks),
                         (J.plan_psgd_tasks, T.plan_psgd_tasks)):
        want = [(t.name, t.path, t.index, t.rows, t.cols, t.transpose)
                for t in jplan(jp, min_size)]
        got = [(t.name, t.path, t.index, t.rows, t.cols, t.transpose)
               for t in tplan(tp, min_size)]
        assert got == want and got


def test_engine_q_orthonormal_ft_and_within_jax_q(rng):
    M = rng.standard_normal((128, 48)).astype(np.float32)
    jeng = J.QREngine(n_lanes=4, panel_width=16)
    Qj = np.asarray(jeng.orthonormalize(jnp.asarray(M)))
    eng = T.QREngine(n_lanes=4, panel_width=16)
    Q = eng.orthonormalize(torch.from_numpy(M))
    assert Q.shape == M.shape
    assert np.abs(Q.numpy().T @ Q.numpy() - np.eye(48)).max() < 1e-4
    np.testing.assert_allclose(Q.numpy(), Qj, rtol=RTOL,
                               atol=ATOL * np.linalg.cond(M))
    assert _stats(eng) == _stats(jeng)
    killer = ScriptedKiller({(0, "trailing", 0): [2]})
    Qk = T.QREngine(n_lanes=4, panel_width=16, fault_hooks=[killer]).orthonormalize(
        torch.from_numpy(M))
    assert torch.equal(Q, Qk)
    # a wide matrix: the row space, the Muon convention
    W = T.QREngine(n_lanes=4, panel_width=16).orthonormalize(torch.from_numpy(M.T.copy()))
    assert torch.equal(W, Q.T)


def test_engine_async_matches_sync(rng):
    M = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    kill = {(1, "trailing", 0): [1]}
    Qs = T.QREngine(n_lanes=4, fault_hooks=[ScriptedKiller(kill)]).orthonormalize(M)
    Qa = T.QREngine(n_lanes=4, async_segments=True,
                    fault_hooks=[ScriptedKiller(kill)]).orthonormalize(M)
    assert torch.equal(Qs, Qa)


def test_mesh_waits_for_axis_comm(lane_group):
    """A mesh whose lane count is not the engine's raises, as the
    reference asserts; nothing is spawned for it."""
    mesh = spmd_qr.make_lane_mesh(4, device="cpu", group=lane_group)
    with pytest.raises(AssertionError):
        T.QREngine(n_lanes=2, mesh=mesh)
    with pytest.raises(AssertionError):
        _port(tcfg=_tt(optimizer="caqr_muon"),
              fcfg=T.FTRunConfig(use_mesh=True, qr_lanes=2), mesh=mesh)
    with pytest.raises(AssertionError):
        T.QREngine(n_lanes=4, mesh=spmd_qr.make_lane_mesh(4, axis_name="lanes",
                                                          device="cpu"))


# -- against JAX ---------------------------------------------------------------


def test_one_muon_step_from_jax_state_within_tolerance(jax_muon):
    tr = _port(tcfg=_tt(optimizer="caqr_muon"))
    tr.state = _carry(jax_muon["entry2"], tr.state)
    m = tr._execute_step(2, tr._lane_batch(2))
    for key in ("loss", "lr", "gnorm"):
        np.testing.assert_allclose(float(m[key]), float(jax_muon["metrics2"][key]),
                                   rtol=RTOL, atol=ATOL)
    want = jax_muon["after2"]
    assert int(tr.state.step) == int(want.step) == 3
    _close_tree(tr.state.params, want.params)
    _close_tree(tr.state.opt_state, want.opt_state)
    # six (128, 64) sweeps a step, the attention leaves on _orth
    assert tr.engine.sweeps == 6 and len(tr._tasks) == 6


def test_one_psgd_bridge_step_from_jax_state_within_tolerance(jax_psgd):
    tr = _port(tcfg=_tt(optimizer="adamw", steps=2),
               fcfg=T.FTRunConfig(compression_rank=4, compression_min_size=4096))
    assert [t.name for t in tr._tasks] == [t.name for t in jax_psgd["tasks"]]
    tr.state = _carry(jax_psgd["entry"], tr.state)
    tr._psgd = {k: {f: torch.from_numpy(np.array(v[f])) for f in ("omega", "err")}
                for k, v in jax_psgd["psgd"].items()}
    m = tr._execute_step(1, tr._lane_batch(1))
    np.testing.assert_allclose(float(m["loss"]), float(jax_psgd["metrics"]["loss"]),
                               rtol=RTOL, atol=ATOL)
    _close_tree(tr.state.params, jax_psgd["after"].params)
    _close_tree(tr.state.opt_state, jax_psgd["after"].opt_state)
    for name, want in jax_psgd["after_psgd"].items():
        for f in ("omega", "err"):
            np.testing.assert_allclose(tr._psgd[name][f].numpy(), np.asarray(want[f]),
                                       rtol=RTOL, atol=ATOL, err_msg=f"{name} {f}")


def test_engine_stats_and_struck_equal_jax(jax_muon, jax_kill, port_ff):
    tr, _ = port_ff
    assert _stats(tr.engine) == jax_muon["stats"] == (24, 480, 480)
    killer = T.StepSweepKiller(at_step=2, lane=1)
    tk = _port(tcfg=_tt(optimizer="caqr_muon"), qr_fault_hooks=[killer])
    hist = tk.run()
    struck, jstats = jax_kill
    assert killer.struck == struck == (2, "groups/l0/ffn/.w_in#0", (0, "leaf", 0))
    assert _stats(tk.engine) == jstats
    # inside the port: kill == failure-free, healed inside the sweep
    ref, hist_ref = port_ff
    assert _equal(tk.state.params, ref.state.params)
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_ref]
    assert [h["step"] for h in hist] == list(range(4))


def test_jax_suspended_sweep_resumes_in_port(jax_muon, jax_suspended):
    d, exc = jax_suspended
    assert exc.step == 3
    tr = T.FTTrainer.resume(get_smoke(ARCH), _tt(optimizer="caqr_muon", ckpt_dir=d),
                            TD, device="cpu")
    assert tr._pending_resume[0] == exc.task and tr._start_step == 3
    tr.run()
    assert tr._pending_resume is None
    _close_tree(tr.state.params, jax_muon["final"].params)


# -- bitwise inside the port -----------------------------------------------------


def test_async_segments_equal_sync(port_ff):
    killer = T.StepSweepKiller(at_step=1, lane=3)
    tr = _port(tcfg=_tt(optimizer="caqr_muon"),
               fcfg=T.FTRunConfig(async_segments=True), qr_fault_hooks=[killer])
    tr.run()
    assert killer.fired
    assert _equal(tr.state.params, port_ff[0].state.params)


def test_suspend_resume_equals_uninterrupted(tmp_path, port_ff):
    tcfg = _tt(optimizer="caqr_muon", ckpt_dir=str(tmp_path))
    tr = _port(tcfg=tcfg, fcfg=T.FTRunConfig(suspend_after_boundaries=SUSPEND_PORT))
    with pytest.raises(T.TrainingSuspended) as exc:
        tr.run()
    assert exc.value.step == 2 and exc.value.task == "groups/l0/ffn/.w_gate#0"
    resumed = T.FTTrainer.resume(get_smoke(ARCH), tcfg, TD, device="cpu")
    assert resumed._pending_resume[0] == exc.value.task
    resumed.run()
    assert _equal(resumed.state.params, port_ff[0].state.params)
    assert _equal(resumed.state.opt_state, port_ff[0].state.opt_state)


def test_mds_two_deaths_at_one_boundary_equal_failure_free(port_ff):
    killers = [T.StepSweepKiller(at_step=1, lane=lane, point=MDS_POINT) for lane in (0, 1)]
    tr = _port(tcfg=_tt(optimizer="caqr_muon"), fcfg=T.FTRunConfig(mds_f=2),
               qr_fault_hooks=killers)
    tr.run()
    assert all(k.fired for k in killers)
    assert killers[0].struck == killers[1].struck
    assert _equal(tr.state.params, port_ff[0].state.params)


def test_psgd_bridge_kill_equals_failure_free(port_psgd_ff):
    ref, hist_ref = port_psgd_ff
    killer = T.StepSweepKiller(at_step=1, lane=2)
    tr = _port(tcfg=_tt(optimizer="adamw", steps=2),
               fcfg=T.FTRunConfig(compression_rank=4, compression_min_size=4096),
               qr_fault_hooks=[killer])
    hist = tr.run()
    assert killer.fired and killer.struck[1] == "embed"
    assert _equal(tr.state.params, ref.state.params)
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_ref]
    assert all(torch.equal(tr._psgd[k][f], ref._psgd[k][f])
               for k in ref._psgd for f in ("omega", "err"))


# -- one process per lane --------------------------------------------------------


def test_mesh_trainer_equals_simcomm_trainer(mesh_runs):
    """Every sweep's points over four rank processes: params and the loss
    curve bit-equal to the SimComm engine's, K1-K4's plain path in every
    rank and every point joined back."""
    (ref, hist), (sim, hist_sim) = mesh_runs["ff"], mesh_runs["sim"]
    assert _equal(ref.state.params, sim.state.params)
    assert _equal(ref.state.opt_state, sim.state.opt_state)
    assert [h["loss"] for h in hist] == [h["loss"] for h in hist_sim]
    assert _stats(ref.engine) == _stats(sim.engine)
    e = ref.engine
    assert e.step_stats["points"] == e.boundaries == 3 * 6 * 20
    assert len(e.rank_reports) == 4
    assert all(r.staged["collectives"] > 0 for r in e.rank_reports)


def test_mesh_trainer_kill_equals_failure_free(mesh_runs):
    """A lane killed inside step 1's first sweep on the ranks: healed by
    one single-source REBUILD inside the step, params and losses bit-equal
    to the failure-free mesh run, no training-level rewind."""
    (ref, hist), (tr, hist_k, killer) = mesh_runs["ff"], mesh_runs["kill"]
    assert killer.fired and killer.struck[:2] == (1, "groups/l0/ffn/.w_in#0")
    assert _equal(tr.state.params, ref.state.params)
    assert [h["loss"] for h in hist_k] == [h["loss"] for h in hist]
    assert [h["step"] for h in hist_k] == [0, 1, 2]
    assert len(tr.engine.events) == 1 and tr.engine.events[0].lane == 3


def test_mesh_trainer_owns_and_closes_its_ranks():
    """``FTRunConfig(use_mesh=True)`` with no mesh given: the trainer
    spawns its mesh's ranks at the first sweep and stops them on leaving
    its ``with`` block; the engine's Q equals the SimComm engine's."""
    M = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (64, 16)).astype(np.float32))
    with _port(tcfg=_tt(optimizer="caqr_muon"),
               fcfg=T.FTRunConfig(use_mesh=True, qr_lanes=2)) as tr:
        assert tr.mesh.group is None
        Q = tr.engine.orthonormalize(M)
        procs = tr.mesh.group._procs
        assert len(procs) == 2 and all(p.is_alive() for p in procs)
    assert not any(p.is_alive() for p in procs) and tr.mesh.group is None
    assert torch.equal(Q, T.QREngine(n_lanes=2, panel_width=16).orthonormalize(M))
