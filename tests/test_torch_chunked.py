"""The port's streaming attention (``repro_torch.models.attention.
chunked_attention``) and the model paths that take it, against the JAX
package's, on CPU tensors (f32).

Against JAX, on the same numpy-seeded inputs: ``chunked_attention`` in both
schedules ("tri", "scan"), causal and not, with a sliding window, a softcap
and GQA, at chunk 4 (and q and kv chunks of different sizes), the output
and the gradients of a weighted sum with respect to q, k and v within the
f32 pair of ``repro.kernels.ref.tolerances``; the gemma2 smoke with its
chunk threshold lowered, so every layer of the training forward and of the
prefill takes the streaming path: the loss and every gradient leaf from
JAX's parameters, and the prefill's logits and caches. Inside the port: the
streaming path equals ``full_attention`` within the same tolerance; the
prefill keeps the same roped k and v as the full path (the first layer's
bit for bit); a length that is not a multiple of the chunk raises, as the
reference asserts.
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
from repro.models import api as j_api
from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro.train.step import make_loss_and_grads as j_loss_and_grads
from repro_torch import interop, tree
from repro_torch.configs import get_smoke
from repro_torch.models import api
from repro_torch.models import attention as t_attn
from repro_torch.train.step import make_loss_and_grads

RTOL, ATOL = tolerances(np.float32)
ARCH = "gemma2-2b"
# the smoke with every layer streaming: S >= 16 takes chunks of 8
CHUNKED = dict(attn_chunk_threshold=16, attn_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()


def _qkvw(rng, B=2, S=16, H=4, Kv=2, Dh=8):
    q = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Kv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Kv, Dh)).astype(np.float32)
    w = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    return q, k, v, w


CASES = {
    "causal": dict(),
    "window": dict(window=6),
    "window-cap": dict(window=5, cap=30.0),
    "cap": dict(cap=20.0),
    "noncausal": dict(causal=False),
    "q4-kv8": dict(window=7, q_chunk=4, kv_chunk=8),
    "q8-kv4": dict(window=7, q_chunk=8, kv_chunk=4),
}


@pytest.mark.parametrize("schedule", ["tri", "scan"])
@pytest.mark.parametrize("case", list(CASES))
def test_chunked_attention_and_its_gradients_match_jax(rng, schedule, case):
    kw = dict(dict(n_kv=2, q_chunk=4, kv_chunk=4, schedule=schedule), **CASES[case])
    q, k, v, w = _qkvw(rng)

    def j_loss(q, k, v):
        return jnp.sum(j_attn.chunked_attention(q, k, v, **kw) * w)

    want = j_attn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    want_g = jax.grad(j_loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = t_attn.chunked_attention(tq, tk, tv, **kw)
    torch.sum(got * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for name, g, wg in zip("qkv", (tq.grad, tk.grad, tv.grad), want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("schedule", ["tri", "scan"])
def test_chunked_equals_full_attention(rng, schedule):
    q, k, v, _ = _qkvw(rng, S=32)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    for window in (None, 9):
        got = t_attn.chunked_attention(*args, n_kv=2, window=window, cap=50.0,
                                       q_chunk=8, kv_chunk=8, schedule=schedule)
        want = t_attn.full_attention(*args, n_kv=2, window=window, cap=50.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_chunk_length_contract_raises(rng):
    q, k, v, _ = (torch.from_numpy(x) for x in _qkvw(rng, S=12))
    for qc, kc in ((8, 4), (4, 8), (5, 5)):
        with pytest.raises(ValueError, match="not a multiple"):
            t_attn.chunked_attention(q, k, v, n_kv=2, q_chunk=qc, kv_chunk=kc)
    with pytest.raises(ValueError, match="schedule"):
        t_attn.chunked_attention(q, k, v, n_kv=2, q_chunk=4, kv_chunk=4,
                                 schedule="ring")


def _batch(cfg):
    return make_batch(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                                 seed=2), 0)


@pytest.fixture(scope="module")
def jax_params():
    return j_tf.init_params(j_get_smoke(ARCH), jax.random.key(3))


@pytest.mark.parametrize("schedule", ["scan", "tri"])
def test_streaming_training_forward_matches_jax(jax_params, schedule):
    """Sequence 32 over chunks of 8 and a window of 16: the local layers
    skip (tri) or mask (scan) the chunks out of the window."""
    jcfg = dataclasses.replace(j_get_smoke(ARCH), attn_schedule=schedule, **CHUNKED)
    tcfg = dataclasses.replace(get_smoke(ARCH), attn_schedule=schedule, **CHUNKED)
    batch = _batch(jcfg)
    jl, jg = jax.jit(j_loss_and_grads(jcfg))(
        jax_params, {k: jnp.asarray(v) for k, v in batch.items()})
    params = interop.params_from_arrays(j_flatten(jax_params), tcfg, device="cpu")
    tl, tg = make_loss_and_grads(tcfg)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL, atol=ATOL)
    want, got = j_flatten(jg), dict(tree.flatten_with_path(tg))
    assert list(got) == list(want)
    for path, g in want.items():
        np.testing.assert_allclose(got[path].numpy(), g, rtol=RTOL, atol=ATOL,
                                   err_msg=path)


def test_streaming_prefill_matches_jax_and_the_full_path(jax_params):
    jcfg = dataclasses.replace(j_get_smoke(ARCH), **CHUNKED)
    tcfg = dataclasses.replace(get_smoke(ARCH), **CHUNKED)
    tokens = _batch(jcfg)["tokens"]
    jl, jc = jax.jit(j_api.make_prefill(jcfg))(jax_params,
                                               {"tokens": jnp.asarray(tokens)})
    params = interop.params_from_arrays(j_flatten(jax_params), tcfg, device="cpu")
    with torch.no_grad():
        tl, tc = api.make_prefill(tcfg)(params, {"tokens": torch.from_numpy(tokens)})
        fl, fc = api.make_prefill(get_smoke(ARCH))(
            params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(tl.numpy(), fl.numpy(), rtol=RTOL, atol=ATOL)
    want, got = j_flatten(jc), interop.caches_to_arrays(tc)
    full = interop.caches_to_arrays(fc)
    assert list(got) == list(want) == list(full)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4, atol=2e-4,
                                   err_msg=path)
        np.testing.assert_allclose(got[path], full[path], rtol=RTOL, atol=ATOL,
                                   err_msg=path)
    # the first layer's k and v are its input's projections, the same bits
    # whichever attention path the layer then takes
    for f in "kv":
        np.testing.assert_array_equal(got[f"groups/l0/.{f}"][0],
                                      full[f"groups/l0/.{f}"][0])
