"""The port's transformer (``repro_torch.models``) against the JAX
package's, on CPU tensors at the ``tinyllama`` smoke config (f32; the loss
and gradients also at the ``gemma2``, ``mamba2``, ``recurrentgemma``,
``whisper`` and ``pixtral`` smokes).

Exactly: the parameter tree's flattened paths (the checkpoint keys, the
Muon task names), shapes and dtypes, in JAX's leaf order, for tinyllama
and the four families of the SSM, RG-LRU, encoder and VLM mixers, at smoke
size and at the published widths. Within the f32 pair of
``repro.kernels.ref.tolerances``: with JAX's parameters carried across
(``interop.params_from_arrays``), the loss and every gradient leaf, for
one and two microbatches and for the chunked CE (whisper with frame
embeddings through its encoder, pixtral with patch embeddings; JAX's
mamba2 at chunk 4, where its gradients are finite: see
``tests/test_torch_ssm.py``); ``rope``, ``rms_norm`` and
``full_attention`` on the same numpy inputs. The paths that still wait
for their port raise, and so does a chunked length the reference's
asserts refuse.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ckpt.save import _flatten as j_flatten
from repro.configs import get_smoke as j_get_smoke
from repro.data.pipeline import DataConfig, make_batch
from repro.kernels.ref import tolerances
from repro.models import attention as j_attn
from repro.models import common as j_common
from repro.models import transformer as j_tf
from repro.train.step import make_loss_and_grads as j_loss_and_grads
from repro_torch import interop, tree
from repro_torch.configs import get_smoke
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import transformer as t_tf
from repro_torch.train.step import make_loss_and_grads

RTOL, ATOL = tolerances(np.float32)
ARCH = "tinyllama-1.1b"
FAMILIES = ("mamba2-2.7b", "recurrentgemma-9b", "whisper-base", "pixtral-12b")


def _j_smoke(arch):
    """JAX's smoke config; mamba2's at chunk 4: at its own chunk of 8 the
    reference's gradients hold NaN (``tests/test_torch_ssm.py``), and the
    function is the same at any chunk."""
    cfg = j_get_smoke(arch)
    if cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=4))
    return cfg


def _paths(flat_items):
    return [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in flat_items]


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def jax_params():
    return j_tf.init_params(j_get_smoke(ARCH), jax.random.key(0))


def _batch(cfg, step=0):
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=1)
    return make_batch(dcfg, step)


def test_init_paths_shapes_and_dtypes_equal_jax(jax_params):
    want = [(k, v.shape, str(v.dtype)) for k, v in j_flatten(jax_params).items()]
    for params in (t_tf.init_params(get_smoke(ARCH), torch.Generator().manual_seed(0)),
                   t_tf.param_template(get_smoke(ARCH))):
        got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
               for p, x in tree.flatten_with_path(params)]
        assert got == want
    assert "groups/l0/attn/.wq" in dict((k, 0) for k, *_ in want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_init_paths_shapes_and_dtypes_equal_jax(arch):
    want = [(k, v.shape, str(v.dtype)) for k, v in
            j_flatten(j_tf.init_params(j_get_smoke(arch), jax.random.key(0))).items()]
    for params in (t_tf.init_params(get_smoke(arch), torch.Generator().manual_seed(0)),
                   t_tf.param_template(get_smoke(arch))):
        assert _paths(tree.flatten_with_path(params)) == want


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_full_width_templates_match_published_shapes(arch):
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config

    abstract = jax.eval_shape(lambda k: j_tf.init_params(j_get_config(arch), k),
                              jax.random.key(0))
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
             tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]]
    assert _paths(tree.flatten_with_path(t_tf.param_template(get_config(arch)))) == want


def test_full_width_template_matches_published_shapes():
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config

    abstract = jax.eval_shape(lambda k: j_tf.init_params(j_get_config(ARCH), k),
                              jax.random.key(0))
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
             tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]]
    got = [(p, tuple(x.shape))
           for p, x in tree.flatten_with_path(t_tf.param_template(get_config(ARCH)))]
    assert got == want
    assert dict(got)["groups/l0/ffn/.w_in"] == (22, 2048, 5632)


@pytest.mark.parametrize("arch,grad_accum,loss_chunk",
                         [(ARCH, 1, 8192), (ARCH, 2, 8192), (ARCH, 1, 64),
                          ("gemma2-2b", 1, 8192)]
                         + [(a, 1, 8192) for a in FAMILIES],
                         ids=["one-chunk", "accum2", "chunked-ce", "gemma2",
                              "mamba2", "recurrentgemma", "whisper", "pixtral"])
def test_loss_and_every_gradient_leaf_within_tolerance(jax_params, arch, grad_accum,
                                                       loss_chunk):
    """gemma2's smoke adds local/global layers (sequence 32 over a window of
    16), geglu, sandwich norms, both softcaps, the embedding scale and tied
    embeddings; recurrentgemma's RG-LRU layers and a local layer past its
    window; whisper's batch carries frame embeddings (its encoder and
    cross-attention get gradients), pixtral's patch embeddings."""
    jcfg = dataclasses.replace(_j_smoke(arch), loss_chunk=loss_chunk)
    tcfg = dataclasses.replace(get_smoke(arch), loss_chunk=loss_chunk)
    if arch != ARCH:
        jax_params = j_tf.init_params(j_get_smoke(arch), jax.random.key(0))
    batch = _batch(jcfg)
    rng = np.random.default_rng(4)
    if jcfg.vlm is not None:
        batch["patch_embeds"] = rng.standard_normal(
            (8, jcfg.vlm.n_patches, jcfg.d_model)).astype(np.float32)
    if jcfg.encoder is not None:
        batch["enc_frames"] = rng.standard_normal(
            (8, jcfg.encoder.n_frames, jcfg.d_model)).astype(np.float32)
    jl, jg = jax.jit(j_loss_and_grads(jcfg, grad_accum))(
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = interop.params_from_arrays(j_flatten(jax_params), tcfg, device="cpu")
    tl, tg = make_loss_and_grads(tcfg, grad_accum)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    want = j_flatten(jg)
    got = dict(tree.flatten_with_path(tg))
    assert list(got) == list(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path].numpy(), g, rtol=RTOL, atol=ATOL,
                                   err_msg=path)


def test_remat_changes_no_value(jax_params):
    cfg = get_smoke(ARCH)
    params = interop.params_from_arrays(j_flatten(jax_params), cfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 3).items()}
    la, ga = make_loss_and_grads(cfg)(params, batch)
    lb, gb = make_loss_and_grads(dataclasses.replace(cfg, remat="none"))(params, batch)
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(ga), tree.leaves(gb)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_jax(rng, dtype):
    tol = tolerances(np.float32 if dtype == "float32" else jnp.bfloat16)
    x = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    scale = rng.standard_normal((8,)).astype(np.float32)
    pos = np.arange(16)[None].repeat(2, 0)
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = t_common.rms_norm(tx, torch.from_numpy(scale).to(tx.dtype), 1e-6)
    want = j_common.rms_norm(jx, jnp.asarray(scale, dtype), 1e-6)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1])
    got = t_common.rope(tx, torch.from_numpy(pos), 10_000.0)
    want = j_common.rope(jx, jnp.asarray(pos), 10_000.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("window,cap", [(None, None), (5, 30.0)])
def test_full_attention_matches_jax(rng, window, cap):
    B, S, H, Kv, Dh = 2, 12, 8, 2, 8
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, Dh)).astype(np.float32)
    want = j_attn.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 n_kv=Kv, window=window, cap=cap)
    got = t_attn.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), n_kv=Kv, window=window,
                                cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_unported_paths_raise():
    """A length the chunked paths cannot take raises, as the reference
    asserts: attention's chunk at S >= the threshold, the SSD chunk in a
    mamba2 layer. The multi-pod step runs (two pods as threads of one
    process: a finite loss, one step) and refuses a mesh without a 'pod'
    axis."""
    from repro_torch.dist import compat
    from repro_torch.optim import adamw, schedule
    from repro_torch.train.step import PodTrainState, make_pod_train_step

    cfg = get_smoke(ARCH)
    opt = adamw.adamw()
    with pytest.raises(ValueError, match="'pod'"):
        make_pod_train_step(cfg, opt, schedule.constant(1e-3),
                            compat.make_mesh((2,), ("data",), device="cpu"))
    step = make_pod_train_step(
        cfg, opt, schedule.constant(1e-3),
        compat.make_mesh((2,), ("pod",), device="cpu", threads=True))
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(0))
    state = PodTrainState(params, opt.init(params), None,
                          torch.zeros((), dtype=torch.int32))
    batch = {"tokens": torch.zeros(4, 8, dtype=torch.int32),
             "labels": torch.ones(4, 8, dtype=torch.int32)}
    state, metrics = step(state, batch)
    assert int(state.step) == 1 and torch.isfinite(metrics["loss"])
    tokens = torch.zeros(1, 12, dtype=torch.int32)
    chunked = dataclasses.replace(get_smoke(ARCH), attn_chunk_threshold=8, attn_chunk=8)
    mamba = get_smoke("mamba2-2.7b")
    assert 12 % mamba.ssm.chunk
    for cfg in (chunked, mamba):
        params = t_tf.init_params(cfg, torch.Generator().manual_seed(0))
        for mode in ("train", "prefill"):
            with pytest.raises(ValueError, match="not a multiple"):
                t_tf.forward(cfg, params, tokens, mode=mode)


def test_zero_momentum_orthonormalizes_as_jax():
    """Whisper trains without frame embeddings (the data pipeline has none),
    so its encoder and cross-attention weights get zero gradients and
    CAQR-Muon orthonormalizes a zero momentum: [I; 0] in both packages."""
    from repro.optim.caqr_muon import _orth2d as j_orth2d
    from repro_torch.optim.caqr_muon import _orth2d

    want = np.asarray(j_orth2d(jnp.zeros((512, 64), jnp.float32)))
    got = _orth2d(torch.zeros(512, 64)).numpy()
    eye = np.zeros((512, 64), np.float32)
    eye[:64] = np.eye(64)
    np.testing.assert_array_equal(np.abs(want), eye)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_launcher_trains_the_stub_families_on_cpu(arch, capsys):
    """The data pipeline gives tokens alone: whisper trains its decoder (the
    encoder and cross-attention weights get zero gradients), pixtral its
    backbone."""
    from repro_torch.launch import train as t_launch

    t_launch.main(["--arch", arch, "--device", "cpu", "--optimizer", "caqr_muon",
                   "--steps", "2", "--global-batch", "8", "--seq-len", "32"])
    out = capsys.readouterr().out
    assert "step     0 loss" in out and "nan" not in out
