"""The port's distributed helpers (``repro_torch.dist``, ``launch/mesh.py``,
``ft/elastic.py``'s mesh helpers) against the JAX package's.

Exactly: the specs of ``tree_shardings``, ``batch_shardings`` and
``cache_shardings`` (JAX's on ``jax.sharding.AbstractMesh`` meshes of 1, 2
and 3 axes) and every leaf's ``shard_shape``, on the smoke models'
parameter and cache trees (abstract in both packages: ``jax.eval_shape``
and the port's meta tensors); the rule tables; the production and QR
meshes' shapes and names (they spawn nothing); ``reshard`` ->
``shrink_mesh`` -> ``reshard`` passing values through bit for bit and
``rebalance_batch``, as ``tests/test_spmd_subprocess.py::
test_elastic_shrink_reshard`` holds the reference. ``shard_map`` over a
(2, 2) mesh with both axes manual, on four spawned ranks (one module
fixture) and on threads, against numpy.
"""
import functools

import numpy as np
import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_smoke as j_get_smoke
from repro.dist import params_sharding as j_ps
from repro.dist import sharding as j_sh
from repro.models import transformer as j_tf
from repro_torch import tree
from repro_torch.configs import get_smoke
from repro_torch.dist import compat, params_sharding as t_ps, sharding as t_sh
from repro_torch.ft import elastic
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch import spmd_qr
from repro_torch.models import transformer as t_tf

ARCHS = ("tinyllama-1.1b", "mamba2-2.7b", "recurrentgemma-9b", "whisper-base")
MESHES = {
    1: ((8,), ("data",), "data", "data", None),
    2: ((4, 2), ("data", "model"), ("data", "model"), "data", "model"),
    3: ((2, 2, 2), ("pod", "data", "model"), ("data", "model"),
        ("pod", "data"), "model"),
}


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def group():
    g = spmd_qr.make_lane_group(4, device="cpu", timeout_s=60.0)
    yield g
    g.close()
    assert not any(p.is_alive() for p in g._procs)


def _trees(arch):
    jcfg, cfg = j_get_smoke(arch), get_smoke(arch)
    jp = jax.eval_shape(lambda: j_tf.init_params(jcfg, jax.random.key(0)))
    jc = jax.eval_shape(lambda: j_tf.init_caches(jcfg, 4, 16))
    return (jp, t_tf.param_template(cfg)), (jc, t_tf.init_caches(cfg, 4, 16,
                                                                 device="meta"))


def _specs(shardings, leaves):
    return [(tuple(s.spec), tuple(s.shard_shape(tuple(x.shape))))
            for s, x in zip(shardings, leaves)]


@pytest.mark.parametrize("n_axes", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_equal_jax(arch, n_axes):
    shape, names, fsdp, batch, kv_seq = MESHES[n_axes]
    jm = AbstractMesh(shape, names)
    tm = compat.make_mesh(shape, names, device="cpu")
    (jp, tp), (jc, tc) = _trees(arch)
    jl = jax.tree_util.tree_leaves

    def both(j_fn, t_fn, jt, tt, *args):
        want = _specs(jl(j_fn(jt, jm, *args)), jl(jt))
        got = _specs(tree.leaves(t_fn(tt, tm, *args)), tree.leaves(tt))
        assert got == want, (j_fn.__name__, args)

    both(j_ps.tree_shardings, t_ps.tree_shardings, jp, tp, fsdp)
    both(j_ps.batch_shardings, t_ps.batch_shardings, jp, tp, batch)
    both(j_ps.cache_shardings, t_ps.cache_shardings, jc, tc, batch, kv_seq)
    both(j_ps.cache_shardings, t_ps.cache_shardings, jc, tc, None, kv_seq)
    assert tm.group is None  # nothing spawned


def test_rule_tables_and_ax_equal_jax():
    assert t_sh.single_pod_rules() == j_sh.single_pod_rules()
    assert t_sh.multi_pod_rules() == j_sh.multi_pod_rules()
    assert (t_sh.long_decode_overrides(t_sh.multi_pod_rules())
            == j_sh.long_decode_overrides(j_sh.multi_pod_rules()))
    x = torch.zeros(2, 3)
    assert t_sh.ax(x, "batch") is x  # the identity outside rules
    with t_sh.use_rules(t_sh.multi_pod_rules()):
        assert t_sh.ax(x, "batch", "ff") is x
        with pytest.raises(AssertionError):
            t_sh.ax(x, "batch")
    assert t_sh.current_rules() is None


def test_production_and_qr_meshes():
    want = {(False, "prod"): ((16, 16), ("data", "model")),
            (True, "prod"): ((2, 16, 16), ("pod", "data", "model")),
            (False, "qr"): ((256,), ("qr",)),
            (True, "qr"): ((512,), ("qr",))}
    for (multi, kind), (shape, names) in want.items():
        fn = t_mesh.make_production_mesh if kind == "prod" else t_mesh.make_qr_mesh
        m = fn(multi_pod=multi)
        assert m.devices.shape == shape and m.axis_names == names
        assert m.shape == dict(zip(names, shape)) and m.group is None
    small = t_mesh.make_small_mesh()
    assert small.shape == {"data": 4, "model": 2}
    lane = spmd_qr.make_lane_mesh(8, device="cpu")
    assert lane.devices.shape == (8,) and lane.axis_names == ("qr",)


def test_elastic_shrink_reshard():
    mesh = elastic.make_data_model_mesh(4, 2, device="cpu")
    params = {"w": torch.arange(64.0).reshape(8, 8)}
    sharded = elastic.reshard(params, mesh)
    small = elastic.shrink_mesh(mesh, dead_data_lane=1)
    assert small.devices.shape == (3, 2)
    assert small.devices.tolist() == [[0, 1], [4, 5], [6, 7]]
    resharded = elastic.reshard(sharded, small)
    assert torch.equal(resharded["w"], params["w"])
    split = elastic.reshard(params, mesh, lambda leaf: compat.P("data", "model"))
    assert torch.equal(split["w"], params["w"])
    sh = t_ps.NamedSharding(mesh, compat.P("data", "model"))
    assert sh.shard_shape((8, 8)) == (2, 4)
    assert torch.equal(sh.block(params["w"], (2, 1)), params["w"][4:6, 4:8])
    assert elastic.rebalance_batch(16, 4, 3) == (15, 5)


@pytest.mark.parametrize("threads", [False, True])
def test_shard_map_two_manual_axes(group, threads):
    """A (2, 2) mesh, both axes manual: each element gets its (2, 2) block
    of a (4, 4) matrix and averages it over one axis; the result's other
    axis is joined, the averaged one is element 0's copy."""
    A = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 4)).astype(np.float32))
    mesh = compat.make_mesh((2, 2), ("data", "model"), device="cpu",
                            group=None if threads else group, threads=threads)
    blocks = A.reshape(2, 2, 2, 2)  # (data, row, model, col)
    for name, out_spec, want in (
            ("data", compat.P(None, "model"),
             (blocks[0] + blocks[1]).reshape(2, 4) / 2),
            ("model", compat.P("data", None),
             (blocks[:, :, 0] + blocks[:, :, 1]).reshape(4, 2) / 2)):
        fn = compat.shard_map(functools.partial(compat.pmean, axis_name=name),
                              mesh, (compat.P("data", "model"),), out_spec)
        assert torch.equal(fn(A), want), name
    if not threads:
        assert len(group.last_reports) == 4
        assert all(r.staged["collectives"] == 1 for r in group.last_reports)
    with pytest.raises(NameError, match="not bound"):
        compat.pmean(A, "data")


def test_set_mesh_spawns_and_close_stops_the_ranks():
    """``set_mesh`` binds the ambient mesh and, asked for ranks, spawns the
    mesh's group; ``close`` stops the ranks the mesh spawned."""
    mesh = compat.make_mesh((2,), ("pod",), device="cpu", timeout_s=60.0)
    assert compat.current_mesh() is None and mesh.group is None
    with compat.set_mesh(mesh, ranks=2):
        assert compat.current_mesh() is mesh
        procs = mesh.group._procs
        assert len(procs) == 2 and all(p.is_alive() for p in procs)
        x = torch.arange(4.0)
        fn = compat.shard_map(functools.partial(compat.pmean, axis_name="pod"),
                              mesh, (compat.P("pod"),), compat.P())
        assert torch.equal(fn(x), torch.tensor([1.0, 2.0]))
    assert compat.current_mesh() is None
    mesh.close()
    assert mesh.group is None and not any(p.is_alive() for p in procs)
