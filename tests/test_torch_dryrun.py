"""The port's dry run (``repro_torch.launch.dryrun``) and the spec
functions of ``repro_torch.models.api`` against the JAX package's, on the
CPU.

* The specs of all ten archs at their published widths (meta tensors)
  against ``jax.eval_shape`` of the JAX package's: parameters, train and
  decode inputs (caches at decode_32k, and at long_500k where supported),
  Adafactor's state; paths, shapes and dtypes equal; ``supports_shape``
  the same on all 40 (arch, shape) pairs.
* ``n_params``, ``n_active_params`` and ``model_flops_global`` by the
  reference's formula (``src/repro/launch/dryrun.py::_model_flops``,
  computed here on the JAX package's specs), and the per-device argument
  bytes of every train cell at both production meshes against the JAX
  package's ``_fsdp_spec``/``_batch_spec`` specs (they read only the mesh's
  axis sizes, so a stand-in mesh serves; the reference's dry-run module
  forces 512 host devices at import and is not imported).
* FLOPs counted on meta tensors equal the count on real CPU tensors for
  smoke configs (train, prefill, decode) and for the ``caqr`` cell at
  ``paper_qr.SMOKE`` over 8 lanes, whose collective bytes equal the closed
  form of the butterfly.
"""
import math
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as j_get_config
from repro.configs import paper_qr as j_paper_qr
from repro.configs.base import SHAPES as J_SHAPES
from repro.dist import params_sharding as j_psh
from repro.dist import sharding as j_shd
from repro.models import api as j_api
from repro.optim.adafactor import adafactor as j_adafactor
from repro.optim.adamw import adamw as j_adamw
from repro_torch import tree
from repro_torch.configs import ARCHS, SHAPES, get_config, get_shape, get_smoke, paper_qr
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models import transformer as tf
from repro_torch.optim.adafactor import adafactor


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture
def one_thread():
    """One intra-op thread for the CPU steps (several xdist workers share
    the cores), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jkey(path) -> str:
    # repro.ckpt.save._flatten's key, which the port's path strings follow
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _jspec(t):
    return {_jkey(p): (tuple(x.shape), jnp.dtype(x.dtype).name)
            for p, x in jax.tree_util.tree_flatten_with_path(t)[0]}


def _tspec(t):
    return {p: (tuple(x.shape), str(x.dtype).rsplit(".", 1)[-1])
            for p, x in tree.flatten_with_path(t)}


def _same(port, ref):
    got, want = _tspec(port), _jspec(ref)
    assert list(got) == list(want)
    assert got == want


@pytest.fixture(scope="module")
def jax_params():
    return {arch: j_api.param_specs(j_get_config(arch)) for arch in ARCHS}


def test_supports_shape_agrees_on_every_pair():
    assert [s.name for s in SHAPES] == [s.name for s in J_SHAPES]
    for arch in ARCHS:
        for ts, js in zip(SHAPES, J_SHAPES):
            assert api.supports_shape(get_config(arch), ts) == \
                j_api.supports_shape(j_get_config(arch), js), (arch, ts.name)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_match_jax(arch, jax_params):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    _same(api.param_specs(cfg), jax_params[arch])
    assert all(x.device.type == "meta" for x in tree.leaves(api.param_specs(cfg)))
    for ts, js in zip(SHAPES, J_SHAPES):
        if not api.supports_shape(cfg, ts)[0]:
            continue
        if ts.kind != "decode":
            _same(api.train_input_specs(cfg, ts), j_api.train_input_specs(jcfg, js))
        else:
            _same(api.decode_input_specs(cfg, ts), j_api.decode_input_specs(jcfg, js))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "mixtral-8x22b", "mamba2-2.7b"])
def test_adafactor_state_specs_match_jax(arch, jax_params):
    _same(adafactor().init(api.param_specs(get_config(arch))),
          jax.eval_shape(j_adafactor().init, jax_params[arch]))


def _reference_model_flops(arch, shape_name, jax_params):
    """The reference's ``_model_flops`` on the JAX package's specs."""
    cfg, shape = j_get_config(arch), get_shape(shape_name)
    leaves = jax.tree_util.tree_flatten_with_path(jax_params[arch])[0]
    n_params = sum(int(np.prod(x.shape)) for _, x in leaves)
    if cfg.moe is not None:
        expert = sum(int(np.prod(x.shape)) for p, x in leaves
                     if any(w in str(p) for w in ("w_gate", "w_in", "w_out"))
                     and len(x.shape) >= 4)
        n_active = n_params - expert + expert * cfg.moe.top_k / cfg.moe.n_experts
    else:
        n_active = n_params
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    return (6.0 if shape.kind == "train" else 2.0) * n_active * tokens, n_params, n_active


def test_model_flops_are_the_reference_formula(jax_params):
    cells = dryrun.all_cells()
    assert len(cells) == sum(
        j_api.supports_shape(j_get_config(a), s)[0] for a in ARCHS for s in J_SHAPES)
    for arch, shape in cells:
        got = dryrun._model_flops(get_config(arch), get_shape(shape))
        assert got == pytest.approx(_reference_model_flops(arch, shape, jax_params),
                                    rel=1e-12), (arch, shape)


def _jax_bytes(t, spec_of, axis_sizes):
    """Per-device bytes of a JAX spec tree, each dim over its spec's axes
    rounded up."""
    total = 0
    for x in jax.tree_util.tree_leaves(t):
        spec = spec_of(tuple(x.shape))
        dims = []
        for d, n in enumerate(x.shape):
            axes = spec[d] if d < len(spec) else None
            axes = () if axes is None else (axes,) if isinstance(axes, str) else axes
            dims.append(-(-n // math.prod(axis_sizes[a] for a in axes)))
        total += math.prod(dims) * jnp.dtype(x.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh_kind", ["single", "multi"])
def test_train_argument_bytes_match_the_reference_specs(mesh_kind, jax_params):
    multi = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi, device="meta")
    stand_in = types.SimpleNamespace(shape=dict(mesh.shape))
    fsdp = ("pod", "data") if multi else "data"
    rules = j_shd.multi_pod_rules() if multi else j_shd.single_pod_rules()
    shape = get_shape("train_4k")
    for arch in ARCHS:
        cfg = get_config(arch)
        *_, in_sh, _, _, _, specs = dryrun.build_cell(cfg, shape, mesh, multi)
        got = sum(dryrun.device_bytes(a, s) for a, s in zip(specs, in_sh))
        jp = jax_params[arch]
        opt = (j_adafactor() if dryrun.TRAIN_KNOBS.get(arch, {}).get("opt") == "adafactor"
               else j_adamw())
        fsdp_of = lambda s: j_psh._fsdp_spec(s, stand_in, fsdp)  # noqa: E731
        want = (_jax_bytes(jp, fsdp_of, stand_in.shape)
                + _jax_bytes(jax.eval_shape(opt.init, jp), fsdp_of, stand_in.shape)
                + 4  # the step count, replicated
                + _jax_bytes(j_api.train_input_specs(j_get_config(arch), J_SHAPES[0]),
                             lambda s: j_psh._batch_spec(s, stand_in, rules["batch"]),
                             stand_in.shape))
        assert got == want, arch


SMALL = {"train": ShapeConfig("train_small", 16, 2, "train"),
         "prefill": ShapeConfig("prefill_small", 16, 2, "prefill"),
         "decode": ShapeConfig("decode_small", 16, 2, "decode")}


def _real(x, gen):
    if x.dtype in (torch.int32, torch.int64):
        return torch.randint(0, 8, tuple(x.shape), dtype=x.dtype, generator=gen)
    return (torch.randn(tuple(x.shape), generator=gen) * 0.02).to(x.dtype)


def _counted(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x22b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_flops_equal_real_flops(arch, kind, one_thread):
    cfg = get_smoke(arch)
    mesh = make_production_mesh(device="meta")
    fn, args, *_ = dryrun.build_cell(cfg, SMALL[kind], mesh, False)
    meta = _counted(fn, *args)
    gen = torch.Generator().manual_seed(0)
    params = tf.init_params(cfg, gen)

    def real(t):
        return tree.map(lambda x: x if x.device.type != "meta" else _real(x, gen), t)

    if kind == "train":
        state, batch = args
        real_args = (state._replace(params=params,
                                    opt_state=dryrun._optimizer(cfg.name).init(params)),
                     real(batch))
    elif kind == "prefill":
        real_args = (params, real(args[1]))
    else:
        real_args = (params, real(args[1]), args[2],
                     tf.init_caches(cfg, 2, 16, device="cpu"), *map(real, args[4:]))
    assert meta > 0 and meta == _counted(fn, *real_args)


def test_caqr_cell_counts_on_meta_equal_the_cpu_and_the_closed_form():
    qr, lanes = paper_qr.SMOKE, 8
    assert (qr.m_rows, qr.n_cols, qr.panel) == (j_paper_qr.SMOKE.m_rows,
                                                j_paper_qr.SMOKE.n_cols,
                                                j_paper_qr.SMOKE.panel)
    assert paper_qr.PRODUCTION == paper_qr.QRConfig(**vars(j_paper_qr.PRODUCTION))
    meta = dryrun.caqr_counts(qr.m_rows, qr.n_cols, qr.panel, lanes)
    cpu = dryrun.caqr_counts(qr.m_rows, qr.n_cols, qr.panel, lanes, device="cpu")
    assert meta["flops"] == cpu["flops"] > 0
    assert meta["comm_bytes"] == cpu["comm_bytes"]
    assert meta["kernel_calls"]["replayed"] > 0 and cpu["kernel_calls"]["replayed"] == 0
    # the butterfly: each panel's L levels swap every lane's R (b x b) and
    # C' (b x n) with its buddy, and one psum a panel gathers the R rows
    b, n, L = qr.panel, qr.n_cols, lanes.bit_length() - 1
    panels = n // b
    closed = panels * (L * lanes * (b * b + b * n) + lanes * b * n) * 4
    assert meta["comm_bytes"] == closed
    assert meta["comm_calls"] == {"ppermute": 2 * L * panels, "psum": panels}
    R = cpu["result"].R
    assert torch.isfinite(R).all() and meta["result"].R.shape == R.shape
