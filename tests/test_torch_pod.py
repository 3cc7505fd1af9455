"""The multi-pod training step and PowerSGD-QR over a named axis
(``repro_torch.train.step.make_pod_train_step``,
``repro_torch.optim.powersgd.compress_tree(..., "pod")``) with one rank
process a pod (two spawned ranks in a gloo group on the CPU, one module
fixture), against the JAX package's ``make_pod_train_step`` on a ("pod",)
mesh of two forced host devices (one subprocess) and JAX's
``compress_tree`` under ``jax.vmap(..., axis_name="pod")``.

Within the f32 pair of ``repro.kernels.ref.tolerances``, from state
carried into the port: one step's loss, parameters, optimizer state and
pod 0's PowerSGD state, at compression rank 4 and at 0 (plain pmean);
each pod's reduced gradients, error buffers and next sketches of
``compress_tree``. Bit for bit inside the port: the parameters across the
ranks after each of two steps, and every result of the ranks equal to the
same body run as threads of one process (``Mesh(threads=True)``: the
per-pod arithmetic in one process, summed in pod order).
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
from repro.optim import powersgd as j_psgd
from repro_torch import interop, tree
from repro_torch.configs import get_smoke
from repro_torch.dist import compat
from repro_torch.launch import spmd_qr
from repro_torch.optim import powersgd as t_psgd
from repro_torch.optim.adamw import Optimizer, adamw
from repro_torch.optim.schedule import constant
from repro_torch.train import make_pod_train_step

from spmd_subprocess_util import run_forced_devices

RTOL, ATOL = tolerances(np.float32)
ARCH = "tinyllama-1.1b"
RANKS = (4, 0)

_JAX_POD = """
    import numpy as np, jax, jax.numpy as jnp
    from repro.ckpt.save import _flatten
    from repro.configs import get_smoke
    from repro.data.pipeline import DataConfig, make_batch
    from repro.models import transformer as tf
    from repro.optim.adamw import adamw
    from repro.optim import powersgd
    from repro.optim.schedule import constant
    from repro.train.step import PodTrainState, make_pod_train_step
    from repro.dist import compat

    mesh = compat.make_mesh((2,), ("pod",))
    cfg = get_smoke("tinyllama-1.1b")
    params = tf.init_params(cfg, jax.random.key(0))
    opt = adamw()
    psgd = powersgd.init_state(jax.random.key(1), params, rank=4)
    state = PodTrainState(params, opt.init(params), psgd,
                          jnp.zeros((), jnp.int32))
    batch = make_batch(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=8, seed=0), 0)
    b = {{k: jnp.asarray(v) for k, v in batch.items()}}
    out = {{"in/" + k: v for k, v in _flatten(state).items()}}
    out.update({{"batch/" + k: v for k, v in batch.items()}})
    for r in {ranks}:
        step = make_pod_train_step(cfg, opt, constant(1e-3), mesh,
                                   compression_rank=r)
        with compat.set_mesh(mesh):
            s2, m = jax.jit(step)(state, b)
        out.update({{f"r{{r}}/" + k: v for k, v in _flatten(s2).items()}})
        out[f"r{{r}}/loss"] = np.asarray(m["loss"])
    np.savez({path!r}, **out)
    print("POD_DONE")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()


@pytest.fixture(scope="module")
def group():
    g = spmd_qr.make_lane_group(2, device="cpu", timeout_s=60.0)
    yield g
    g.close()
    assert not any(p.is_alive() for p in g._procs)


def _meshes(group):
    return (compat.make_mesh((2,), ("pod",), device="cpu", group=group),
            compat.make_mesh((2,), ("pod",), device="cpu", threads=True))


@pytest.fixture(scope="module")
def jax_pod(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pod") / "pod.npz")
    out = run_forced_devices(_JAX_POD.format(ranks=RANKS, path=path), 2)
    assert "POD_DONE" in out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _sub(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def _carried(jax_pod):
    return interop.pod_state_from_arrays(_sub(jax_pod, "in/"), get_smoke(ARCH),
                                         "adamw", device="cpu")


def _batch(jax_pod):
    return {k: torch.from_numpy(v) for k, v in _sub(jax_pod, "batch/").items()}


def _close(got, want: dict, what: str):
    g = dict(tree.flatten_with_path(got))
    assert sorted(g) == sorted(want), what
    for path, w in want.items():
        np.testing.assert_allclose(g[path].float().numpy(), np.asarray(w, np.float32),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{what} {path}")


def _equal(a, b) -> bool:
    la, lb = tree.leaves(a), tree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("rank", RANKS)
def test_pod_step_matches_jax(group, jax_pod, rank):
    """One step over two rank processes from JAX's state, within the f32
    tolerance of JAX's shard_map step over two devices: the pmean'd loss,
    the parameters, AdamW's moments and pod 0's PowerSGD state."""
    mesh = _meshes(group)[0]
    step = make_pod_train_step(get_smoke(ARCH), adamw(), constant(1e-3), mesh,
                               compression_rank=rank)
    try:
        state, metrics = step(_carried(jax_pod), _batch(jax_pod))
    finally:
        step.close()
    want = _sub(jax_pod, f"r{rank}/")
    np.testing.assert_allclose(float(metrics["loss"]), float(want["loss"]),
                               rtol=RTOL, atol=ATOL)
    assert int(state.step) == 1
    _close(state.params, _sub(want, ".params/"), "params")
    _close(state.opt_state, _sub(want, ".opt_state/"), "opt_state")
    psgd = _sub(want, ".psgd/")
    _close(state.psgd, psgd, "pod 0's PowerSGD state")
    if rank:
        # the compressed leaves' error buffers took the step's residual
        assert any(float(e.abs().max()) > 0 for e in tree.leaves(state.psgd.error))


@pytest.mark.parametrize("rank", RANKS)
def test_pod_step_ranks_bit_equal(group, jax_pod, rank):
    """Two steps: the parameters bit-equal across the ranks after each,
    and every pod's state and the returned one bit-equal to the same body
    run as threads of one process; the error buffers stay per pod (pod 0's
    returned, pod 1's different where compressed)."""
    runs = {}
    for mesh in _meshes(group):
        step = make_pod_train_step(get_smoke(ARCH), adamw(), constant(1e-3),
                                   mesh, compression_rank=rank)
        state, out = _carried(jax_pod), []
        try:
            for _ in range(2):
                state, metrics = step(state, _batch(jax_pod))
                pods = step.rank_states()
                assert _equal(pods[0].params, pods[1].params)
                assert _equal(pods[0], state)
                out.append((state, pods, float(metrics["loss"])))
        finally:
            step.close()
        runs[mesh.threads] = out
    for (s_r, p_r, l_r), (s_t, p_t, l_t) in zip(runs[False], runs[True]):
        assert _equal(s_r, s_t) and l_r == l_t
        assert all(_equal(a, b) for a, b in zip(p_r, p_t))
    pods = runs[False][-1][1]
    if rank:
        assert not _equal(pods[0].psgd.error, pods[1].psgd.error)
    else:
        assert _equal(pods[0].psgd, pods[1].psgd)


def test_compress_tree_over_pod_axis_matches_jax(group):
    """``compress_tree(..., "pod")`` over two ranks from the same carried
    sketches and per-pod errors, against JAX's under ``jax.vmap`` with
    ``axis_name="pod"``: each pod's reduced gradients, errors and next
    sketches within the tolerance; bit-equal to the threads of one
    process."""
    jp = j_tf.init_params(j_get_smoke(ARCH), jax.random.key(0))
    rng = np.random.default_rng(5)
    jst = j_psgd.init_state(jax.random.key(1), jp, rank=4)
    pods = []
    for _ in range(2):
        g = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32), jp)
        e = jax.tree_util.tree_map(
            lambda x: jnp.asarray(0.1 * rng.standard_normal(x.shape), jnp.float32),
            jst.error)
        pods.append((g, j_psgd.PowerSGDState(error=e, sketch=jst.sketch)))
    stack = lambda *xs: jnp.stack(xs)  # noqa: E731
    jg = jax.tree_util.tree_map(stack, *(g for g, _ in pods))
    js = jax.tree_util.tree_map(stack, *(s for _, s in pods))
    jout, jnew = jax.jit(jax.vmap(
        lambda g, s: j_psgd.compress_tree(g, s, "pod", rank=4),
        axis_name="pod"))(jg, js)

    params = interop.params_from_arrays(j_flatten(jp), get_smoke(ARCH), device="cpu")
    each = [(interop.params_from_arrays(j_flatten(g), get_smoke(ARCH), device="cpu"),
             interop.psgd_state_from_arrays(j_flatten(s), params))
            for g, s in pods]
    body = functools.partial(t_psgd.compress_tree, axis_name="pod", rank=4)
    got = {m.threads: compat.run_manual(body, m, each) for m in _meshes(group)}
    for p, (tg, ts) in enumerate(got[False]):
        pick = lambda t: jax.tree_util.tree_map(lambda x: x[p], t)  # noqa: E731
        _close(tg, j_flatten(pick(jout)), f"pod {p} grads")
        _close(ts.error, j_flatten(pick(jnew.error)), f"pod {p} errors")
        _close(ts.sketch, j_flatten(pick(jnew.sketch)), f"pod {p} sketches")
        assert _equal((tg, ts), got[True][p])
    # the reduced gradients and sketches agree across pods; errors do not
    assert _equal(got[False][0][0], got[False][1][0])
    assert _equal(got[False][0][1].sketch, got[False][1][1].sketch)
    # the ranks' reduction sent r (m + n) values a compressed matrix
    assert all(r.staged["collectives"] > 0 for r in group.last_reports)


def test_pod_step_rebuilds_only_from_recipes(group):
    """Ranks rebuild the optimizer and schedule from their factories'
    recipes: a hand-made optimizer is refused on ranks and runs on
    threads; a mesh without a 'pod' axis is refused."""
    cfg = get_smoke(ARCH)
    opt = adamw()
    bare = Optimizer(init=opt.init, update=opt.update)
    ranks, threads = _meshes(group)
    with pytest.raises(ValueError, match="recipe"):
        make_pod_train_step(cfg, bare, constant(1e-3), ranks)
    with pytest.raises(ValueError, match="recipe"):
        make_pod_train_step(cfg, opt, lambda s: torch.tensor(1e-3), ranks)
    make_pod_train_step(cfg, bare, lambda s: torch.tensor(1e-3), threads)
    with pytest.raises(ValueError, match="'pod'"):
        make_pod_train_step(cfg, opt, constant(1e-3),
                            compat.make_mesh((2,), ("data",), device="cpu"))


@pytest.mark.parametrize("threads", [False, True])
def test_pod_step_refuses_a_batch_that_does_not_split(group, jax_pod, threads):
    """A batch whose leading dimension does not divide over the pods is
    refused, as the reference's in-spec P("pod") refuses it, rather than
    trained on in part."""
    mesh = _meshes(group)[threads]
    step = make_pod_train_step(get_smoke(ARCH), adamw(), constant(1e-3), mesh,
                               compression_rank=4)
    batch = {k: torch.cat([v, v[:1]]) for k, v in _batch(jax_pod).items()}
    assert all(v.shape[0] % 2 for v in batch.values())
    try:
        with pytest.raises(ValueError, match="does not split over 2 pods"):
            step(_carried(jax_pod), batch)
    finally:
        step.close()


def _count_calls(kept: dict, x: torch.Tensor, fail: bool = False):
    kept["calls"] = kept.get("calls", 0) + 1
    kept["sum"] = kept.get("sum", 0) + x
    if fail:
        # no collective in this call, so pod 0 finishes whatever pod 1 does
        if compat.axis("pod").rank == 1:
            raise ValueError("pod 1 fails")
        return kept["calls"], None
    return kept["calls"], compat.pmean(kept["sum"], "pod")


@pytest.mark.parametrize("threads", [False, True])
def test_run_manual_session_keeps_state(group, threads):
    """A resident body keeps a dict per element between the calls of its
    session, and its tensors come back as copies the caller owns; a call
    that raises drops what the failing element kept; ``drop_session``
    frees the rest."""
    mesh = _meshes(group)[threads]
    xs = [torch.arange(6.0).reshape(2, 3) + p for p in range(2)]
    token = f"test-{threads}"
    try:
        for call in (1, 2):
            outs = compat.run_manual(_count_calls, mesh, [(x,) for x in xs],
                                     session=token)
            assert [n for n, _ in outs] == [call, call]
            want = call * (xs[0] + xs[1]) / 2
            assert all(torch.equal(m, want) for _, m in outs)
        with pytest.raises(ValueError, match="pod 1 fails"):
            compat.run_manual(functools.partial(_count_calls, fail=True), mesh,
                              [(x,) for x in xs], session=token)
        outs = compat.run_manual(_count_calls, mesh, [(x,) for x in xs],
                                 session=token)
        # pod 0 goes on from its three calls; pod 1 dropped what it kept
        assert [n for n, _ in outs] == [4, 1]
    finally:
        compat.drop_session(mesh, token)
    outs = compat.run_manual(_count_calls, mesh, [(x,) for x in xs],
                             session=token)
    compat.drop_session(mesh, token)
    assert [n for n, _ in outs] == [1, 1]
