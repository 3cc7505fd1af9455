"""The port's training path (``repro_torch.data``, ``ckpt/save.py``,
``train/step.py``, ``train/loop.py``, ``launch/train.py``) against the
JAX package's, CPU tensors, the ``tinyllama`` smoke config (f32),
DataConfig seq 32 / batch 8, 4 lanes.

Exactly: the batches (byte for byte), the checkpoint keys both ways (a
checkpoint either package writes restores in the other, to the bit), the
``lanes`` history under SHRINK and BLANK. Within the f32 pair of
``repro.kernels.ref.tolerances``: one ``Trainer`` step from JAX's carried
state, for ``adamw`` and ``caqr_muon``. Inside the port, bitwise: a
training-level REBUILD (diskless restore, then replay) equals the
failure-free run for both optimizers.
"""
import numpy as np
import jax
import pytest
import torch

from repro.ckpt import save as j_save
from repro.configs import get_smoke as j_get_smoke
from repro.data import pipeline as j_pipe
from repro.ft.failures import FailureSchedule as JFailureSchedule
from repro.ft.semantics import Semantics as JSemantics
from repro.kernels.ref import tolerances
from repro.train import TrainConfig as JTrainConfig
from repro.train import Trainer as JTrainer
from repro_torch import interop, tree
from repro_torch.ckpt import diskless
from repro_torch.ckpt import save as t_save
from repro_torch.configs import get_smoke
from repro_torch.data import pipeline as t_pipe
from repro_torch.ft.failures import FailureSchedule
from repro_torch.ft.semantics import Semantics
from repro_torch.launch import train as t_launch
from repro_torch.train import TrainConfig, Trainer, TrainState

RTOL, ATOL = tolerances(np.float32)
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def dcfg():
    return t_pipe.DataConfig(vocab=256, seq_len=32, global_batch=8, seed=1)


def _jdcfg(dcfg):
    return j_pipe.DataConfig(**{f: getattr(dcfg, f) for f in
                                ("vocab", "seq_len", "global_batch", "seed")})


def _kw(**kw):
    base = dict(steps=4, lr=1e-2, warmup=2, n_lanes=4, diskless_every=2,
                log_every=100)
    base.update(kw)
    return base


def _carry(jstate, like: TrainState) -> TrainState:
    """JAX's TrainState as the port's, through the interop arrays."""
    params = interop.params_from_arrays(j_save._flatten(jstate.params),
                                        get_smoke(ARCH), device="cpu")
    opt = interop.opt_state_from_arrays(
        j_save._flatten(jstate.opt_state), params,
        "caqr_muon" if hasattr(jstate.opt_state, "mom") else "adamw")
    assert type(opt) is type(like.opt_state)
    return TrainState(params, opt, torch.tensor(int(jstate.step), dtype=torch.int32))


def _flat_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


@pytest.mark.parametrize("kind", ["lm_synthetic", "uniform"])
def test_batches_equal_jax_byte_for_byte(dcfg, kind):
    tc = t_pipe.DataConfig(vocab=256, seq_len=32, global_batch=8, seed=1, kind=kind)
    jc = j_pipe.DataConfig(vocab=256, seq_len=32, global_batch=8, seed=1, kind=kind)
    for step in (0, 1, 7):
        for lo, hi in ((0, None), (2, 6)):
            t, j = t_pipe.make_batch(tc, step, lo=lo, hi=hi), j_pipe.make_batch(jc, step, lo=lo, hi=hi)
            assert t.keys() == j.keys()
            for k in t:
                assert t[k].dtype == j[k].dtype and t[k].tobytes() == j[k].tobytes()
    p = t_pipe.Pipeline(tc, start_step=3)
    step, batch = next(p)
    p.close()
    assert step == 3 and batch["tokens"].tobytes() == j_pipe.make_batch(jc, 3)["tokens"].tobytes()


@pytest.mark.parametrize("optimizer", ["adamw", "caqr_muon"])
def test_one_step_from_jax_state_within_tolerance(dcfg, optimizer):
    jt = JTrainer(j_get_smoke(ARCH), JTrainConfig(**_kw(optimizer=optimizer)), _jdcfg(dcfg))
    state = jt.state
    for s in range(2):
        state, _ = jt._step_fn(state, jt._lane_batch(s))
    want, jm = jt._step_fn(state, jt._lane_batch(2))
    tt = Trainer(get_smoke(ARCH), TrainConfig(**_kw(optimizer=optimizer)), dcfg,
                 device="cpu")
    tt.state = _carry(state, tt.state)
    batch = tt._lane_batch(2)
    for k, v in jt._lane_batch(2).items():
        assert batch[k].numpy().tobytes() == np.asarray(v).tobytes()
    got, tm = tt._step_fn(tt.state, batch)
    for key in ("loss", "lr", "gnorm"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=RTOL, atol=ATOL)
    assert int(got.step) == int(want.step) == 3
    for tree_got, tree_want in ((got.params, want.params),
                                (got.opt_state, want.opt_state)):
        w = j_save._flatten(tree_want)
        g = interop.opt_state_to_arrays(tree_got)
        assert list(g) == list(w)
        for path in w:
            np.testing.assert_allclose(g[path], w[path], rtol=RTOL, atol=ATOL, err_msg=path)


@pytest.mark.parametrize("optimizer", ["adamw", "caqr_muon"])
def test_rebuild_replay_is_bit_identical(dcfg, optimizer):
    tcfg = TrainConfig(**_kw(steps=6, optimizer=optimizer,
                             semantics=Semantics.REBUILD))
    ref = Trainer(get_smoke(ARCH), tcfg, dcfg, device="cpu")
    hist_ref = ref.run()
    failed = Trainer(get_smoke(ARCH), tcfg, dcfg, device="cpu")
    hist = failed.run(FailureSchedule(events={3: [2]}))
    assert _flat_equal(ref.state.params, failed.state.params)
    assert _flat_equal(ref.state.opt_state, failed.state.opt_state)
    # the replay re-ran step 2 from the step-2 buddy snapshot
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3, 4, 5]
    by_step = {h["step"]: h["loss"] for h in hist}
    assert [by_step[s] for s in range(6)] == [h["loss"] for h in hist_ref]


@pytest.mark.parametrize("semantics,fail", [("shrink", {2: [1]}), ("blank", {1: [0]})])
def test_shrink_and_blank_lanes_history_equal_jax(dcfg, semantics, fail):
    jt = JTrainer(j_get_smoke(ARCH), JTrainConfig(**_kw(semantics=JSemantics(semantics))),
                  _jdcfg(dcfg))
    jh = jt.run(JFailureSchedule(events=fail))
    tt = Trainer(get_smoke(ARCH), TrainConfig(**_kw(semantics=Semantics(semantics))),
                 dcfg, device="cpu")
    th = tt.run(FailureSchedule(events=fail))
    assert [h["lanes"] for h in th] == [h["lanes"] for h in jh] == [4] * min(fail) + \
        [3] * (4 - min(fail))
    assert [h["step"] for h in th] == [h["step"] for h in jh]
    assert all(np.isfinite(h["loss"]) for h in th)


def test_abort_raises(dcfg):
    tt = Trainer(get_smoke(ARCH), TrainConfig(**_kw(semantics=Semantics.ABORT)), dcfg,
                 device="cpu")
    with pytest.raises(RuntimeError, match="ABORT"):
        tt.run(FailureSchedule(events={1: [1]}))


@pytest.mark.parametrize("optimizer", ["adamw", "caqr_muon"])
def test_checkpoint_round_trip_and_across_packages(tmp_path, dcfg, optimizer):
    tt = Trainer(get_smoke(ARCH), TrainConfig(**_kw(steps=1, optimizer=optimizer)),
                 dcfg, device="cpu")
    tt.run()
    t_save.save(str(tmp_path / "port"), 1, tt.state.params, tt.state.opt_state,
                {"data_step": 1})
    t_save.save_async(str(tmp_path / "async"), 1, tt.state.params,
                      tt.state.opt_state).join()
    for d in ("port", "async"):
        assert t_save.latest_step(str(tmp_path / d)) == 1
        p, o, manifest = t_save.restore(str(tmp_path / d), tt.state.params,
                                        tt.state.opt_state)
        assert _flat_equal(p, tt.state.params) and _flat_equal(o, tt.state.opt_state)
    assert manifest["step"] == 1
    p2, _ = t_save.restore_params(str(tmp_path / "port"), tt.state.params)
    assert _flat_equal(p2, tt.state.params)
    # the port's checkpoint restores in the JAX package, to the bit
    jt = JTrainer(j_get_smoke(ARCH), JTrainConfig(**_kw(steps=1, optimizer=optimizer)),
                  _jdcfg(dcfg))
    jp, jo, jm = j_save.restore(str(tmp_path / "port"), jt.state.params,
                                jt.state.opt_state)
    assert jm["extra"] == {"data_step": 1}
    for got, want in ((j_save._flatten(jp), interop.params_to_arrays(tt.state.params)),
                      (j_save._flatten(jo), interop.opt_state_to_arrays(tt.state.opt_state))):
        assert list(got) == list(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    # and a JAX checkpoint restores in the port
    j_save.save(str(tmp_path / "jax"), 4, jt.state.params, jt.state.opt_state)
    p3, o3, _ = t_save.restore(str(tmp_path / "jax"), tt.state.params, tt.state.opt_state)
    for got, want in ((interop.params_to_arrays(p3), j_save._flatten(jt.state.params)),
                      (interop.opt_state_to_arrays(o3), j_save._flatten(jt.state.opt_state))):
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_bfloat16_state_round_trips_through_stores(tmp_path):
    x = torch.randn(4, 6).to(torch.bfloat16)
    state = {"w": x, "s": torch.zeros((), dtype=torch.int32)}
    store = diskless.BuddyStore(4)
    store.push(1, diskless._to_host(state))
    back = tree.map(lambda a, t: torch.from_numpy(np.array(a)).to(t.dtype),
                    store.recover(1), state)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], x)
    t_save.save(str(tmp_path), 0, state, {})
    p, _ = t_save.restore_params(str(tmp_path), state)
    assert torch.equal(p["w"], x)


def test_launcher_runs_on_cpu_and_needs_cuda_otherwise(capsys):
    t_launch.main(["--device", "cpu", "--optimizer", "caqr_muon", "--steps", "2",
                   "--global-batch", "8", "--seq-len", "16"])
    assert "step     0 loss" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Trainer(get_smoke(ARCH), TrainConfig(**_kw()),
                    t_pipe.DataConfig(vocab=256, seq_len=32, global_batch=8))
