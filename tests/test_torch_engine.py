"""The port's LLM token engine (``repro_torch.serve.engine``, the prefill and
decode modes of ``repro_torch.models``) against the JAX package's, on CPU
tensors at the smoke configs (f32).

Against JAX, with the same numpy-seeded inputs and JAX's parameters
carried across (``interop.params_from_arrays``): ``cache_update`` and
``decode_attention`` on full and rolling caches, before and after the wrap,
within (1e-5, 1e-5); ``init_caches``' paths, shapes and dtypes exactly
(KV caches and the SSM and LRU states); at the gemma2 smoke (prompt 24 over
a window of 16) the prefill's logits and caches, and one ``decode_step``
from JAX's prefill cache (crossed through ``interop.caches_from_arrays``),
within (2e-4, 2e-4); at the mamba2, recurrentgemma, whisper and pixtral
smokes the prefill's logits and caches (recurrent states, the encoder's
and the patch embeddings' effect included) within (2e-4, 2e-4); for every
smoke, each engine's prefill and 12 decode steps on its own caches, fed one
seeded token stream past twice the window, every step's logits within
(2e-4, 2e-4) (whisper's steps with each package's own encoder output); a
6-token greedy ``Engine.generate`` (with random frame or patch embeddings
for whisper and pixtral) equal to JAX's ``Engine`` wherever JAX's top-two
logit margin exceeds 1e-3.

Inside the port: the engine equals its own no-cache greedy rollout; greedy
decoding and a seeded ``temperature > 0`` run repeat; EOS masking; the
per-layer crop of ``_prefill_to_decode_caches``; ``launch.serve`` restores
a checkpoint and serves every family; and the entry points raise without
CUDA unless asked for the CPU.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.ckpt.save import _flatten as j_flatten
from repro.configs import get_smoke as j_get_smoke
from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve.engine import _prefill_to_decode_caches as j_to_decode
from repro_torch import interop, tree
from repro_torch.ckpt import save as t_save
from repro_torch.configs import get_smoke
from repro_torch.launch import serve as t_launch
from repro_torch.models import api
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as t_tf
from repro_torch.serve import Engine, ServeConfig
from repro_torch.serve.engine import _prefill_to_decode_caches

FAMILIES = ("mamba2-2.7b", "recurrentgemma-9b", "whisper-base", "pixtral-12b")
ARCHS = ("tinyllama-1.1b", "gemma2-2b", "mixtral-8x22b") + FAMILIES
B, S0, NEW = 2, 24, 6
LONG = 12              # teacher-forced steps: positions S0 .. 35, past 2 windows
MARGIN = 1e-3          # top-two logit margin above which tokens must agree
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_executables():
    yield
    jax.clear_caches()
    _jax_side.cache_clear()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch while this module runs: the engine runs
    many small ops, and several test processes share the host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(cfg, seed=0, shape=(B, S0)):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape).astype(np.int32)


def _extras(cfg, seed=9):
    """Random stub-frontend inputs (float32, as ``launch.serve`` draws
    them): pixtral's patch embeddings, whisper's frame embeddings."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.vlm is not None:
        out["patch_embeds"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        out["enc_frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    return out


def _enc_out(engine, params, extras, lib):
    """The encoder's output of ``extras`` by JAX's (lib jnp) or the
    port's ``encode``, as the engines compute it, or None."""
    if "enc_frames" not in extras:
        return None
    if lib is jnp:
        return j_tf.encode(engine.cfg, params, jnp.asarray(extras["enc_frames"]))
    return t_tf.encode(engine.cfg, params, torch.from_numpy(extras["enc_frames"]))


@functools.lru_cache(maxsize=None)
def _jax_side(arch):
    """JAX's params (and the port's copy of them), its engine (whose jitted
    prefill and step the tests reuse), its greedy tokens, and the top-two
    margin of the logits each token was read from: the port's prefill and
    cached steps along JAX's trajectory (the two packages' logits agree to
    round-off, and the port's is the cheaper one here)."""
    cfg = j_get_smoke(arch)
    params = j_tf.init_params(cfg, jax.random.key(0))
    prompts = _prompts(cfg)
    extras = _extras(cfg)
    engine = JEngine(cfg, params, JServeConfig(max_new_tokens=NEW))
    out = engine.generate(prompts, extras or None)
    flat = j_flatten(params)
    tcfg = get_smoke(arch)
    tparams = interop.params_from_arrays(flat, tcfg, **CPU)
    teng = Engine(tcfg, tparams, **CPU)
    with torch.no_grad():
        lg, caches = teng._prefill(tparams, _t_batch(prompts, extras))
        caches = teng._relayout(caches, S0, S0 + NEW)
        enc = () if "enc_frames" not in extras else (
            _enc_out(teng, tparams, extras, torch),)
        lgs = [lg]
        for t in range(NEW - 1):
            lg, caches = teng._step(tparams, torch.from_numpy(out[:, t:t + 1]),
                                    S0 + t, caches, *enc)
            lgs.append(lg)
    top2 = torch.topk(torch.cat(lgs, dim=1), 2, dim=-1).values.numpy()
    return dict(cfg=cfg, params=params, flat=flat, tparams=tparams,
                prompts=prompts, extras=extras, engine=engine, out=out,
                margin=top2[..., 0] - top2[..., 1])


def _t_batch(prompts, extras):
    return {"tokens": torch.from_numpy(prompts),
            **{k: torch.from_numpy(v) for k, v in extras.items()}}


def _j_batch(prompts, extras):
    return {"tokens": jnp.asarray(prompts),
            **{k: jnp.asarray(v) for k, v in extras.items()}}


def _port_params(arch):
    return _jax_side(arch)["tparams"]


# -- attention ---------------------------------------------------------------


@pytest.mark.parametrize("window,pos", [(None, 5), (8, 5), (8, 13)],
                         ids=["full", "rolling-before-wrap", "rolling-after-wrap"])
def test_cache_update_and_decode_attention_match_jax(rng, window, pos):
    Bq, S_cache, H, Kv, Dh = 2, 8, 4, 2, 8
    k = rng.standard_normal((Bq, S_cache, Kv, Dh)).astype(np.float32)
    v = rng.standard_normal((Bq, S_cache, Kv, Dh)).astype(np.float32)
    q1 = rng.standard_normal((Bq, 1, H, Dh)).astype(np.float32)
    k1 = rng.standard_normal((Bq, 1, Kv, Dh)).astype(np.float32)
    v1 = rng.standard_normal((Bq, 1, Kv, Dh)).astype(np.float32)
    jc = j_attn.cache_update(j_attn.KVCache(jnp.asarray(k), jnp.asarray(v)),
                             jnp.asarray(k1), jnp.asarray(v1), jnp.asarray(pos))
    want = j_attn.decode_attention(jnp.asarray(q1), jc, jnp.asarray(pos),
                                   n_kv=Kv, window=window, cap=50.0)
    tc = t_attn.KVCache(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
    got_c = t_attn.cache_update(tc, torch.from_numpy(k1), torch.from_numpy(v1), pos)
    assert got_c.k.data_ptr() == tc.k.data_ptr()   # written in place
    got = t_attn.decode_attention(torch.from_numpy(q1), got_c, pos, n_kv=Kv,
                                  window=window, cap=50.0)
    for a, b in ((got_c.k, jc.k), (got_c.v, jc.v), (got, want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_paths_shapes_dtypes_equal_jax(arch):
    jc = jax.eval_shape(lambda: j_tf.init_caches(j_get_smoke(arch), B, 30))
    want = [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path),
             tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]]
    got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in tree.flatten_with_path(
               t_tf.init_caches(get_smoke(arch), B, 30, **CPU))]
    assert got == want


# -- gemma2: prefill and one decode step against JAX ----------------------------


def test_gemma2_prefill_logits_and_caches_match_jax():
    side = _jax_side("gemma2-2b")
    cfg = get_smoke("gemma2-2b")
    assert cfg.sliding_window < S0
    jl, jc = side["engine"]._prefill(side["params"],
                                     {"tokens": jnp.asarray(side["prompts"])})
    with torch.no_grad():
        tl, tc = api.make_prefill(cfg)(
            _port_params("gemma2-2b"), {"tokens": torch.from_numpy(side["prompts"])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    want, got = j_flatten(jc), interop.caches_to_arrays(tc)
    assert list(got) == list(want) == ["groups/l0/.k", "groups/l0/.v",
                                       "groups/l1/.k", "groups/l1/.v"]
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4, atol=2e-4,
                                   err_msg=path)


def test_gemma2_decode_step_from_jax_prefill_cache():
    side = _jax_side("gemma2-2b")
    cfg, jcfg = get_smoke("gemma2-2b"), side["cfg"]
    total = S0 + NEW
    _, jc = side["engine"]._prefill(side["params"],
                                    {"tokens": jnp.asarray(side["prompts"])})
    jc = {"groups": {f"l{i}": j_to_decode(jcfg, jc["groups"][f"l{i}"], S0, total,
                                          mixer=jcfg.mixer_at(i))
                     for i in range(2)}}
    flat = j_flatten(jc)
    token = side["out"][:, :1]
    jl, jc2 = side["engine"]._step(side["params"], jnp.asarray(token),
                                   jnp.asarray(S0, jnp.int32), jc)
    caches = interop.caches_from_arrays(flat, cfg, B, total, **CPU)
    assert caches["groups"]["l0"].k.shape[-3] == cfg.sliding_window
    with torch.no_grad():
        tl, tc2 = t_tf.decode_step(cfg, _port_params("gemma2-2b"), caches,
                                   torch.from_numpy(token), S0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    want, got = j_flatten(jc2), interop.caches_to_arrays(tc2)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4, atol=2e-4,
                                   err_msg=path)


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_prefill_logits_and_caches_match_jax(arch):
    """mamba2 (SSM states), recurrentgemma (LRU states and a rolling local
    layer), whisper (the encoder and cross-attention), pixtral (the patch
    embeddings over the first 8 positions)."""
    side = _jax_side(arch)
    cfg = get_smoke(arch)
    jl, jc = side["engine"]._prefill(side["params"],
                                     _j_batch(side["prompts"], side["extras"]))
    with torch.no_grad():
        tl, tc = api.make_prefill(cfg)(_port_params(arch),
                                       _t_batch(side["prompts"], side["extras"]))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
    want, got = j_flatten(jc), interop.caches_to_arrays(tc)
    assert list(got) == list(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=2e-4, atol=2e-4,
                                   err_msg=path)


# -- the engine against JAX's ----------------------------------------------------


def _j_relayout(cfg, caches, S0, total):
    """The JAX engine's relayout of its prefill caches (the local
    ``relayout`` of ``repro.serve.Engine.generate``)."""
    period, n_groups, _ = j_tf._groups(cfg)
    out = {}
    if caches.get("groups") is not None:
        out["groups"] = {f"l{i}": j_to_decode(cfg, caches["groups"][f"l{i}"], S0,
                                              total, mixer=cfg.mixer_at(i))
                         for i in range(period)}
    for r in range(cfg.n_layers % period if cfg.scan_layers else cfg.n_layers):
        if f"rem{r}" in caches:
            out[f"rem{r}"] = j_to_decode(cfg, caches[f"rem{r}"], S0, total,
                                         mixer=cfg.mixer_at(n_groups * period + r))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_steps_match_jax_logits_past_the_wrap(arch):
    """Each engine's own prefill, relayout and ``_step`` on its own caches,
    fed one seeded token stream for ``LONG`` steps: the prefill's and every
    step's logits within (2e-4, 2e-4) of JAX's. The positions run past twice
    the smokes' window of 16, so the rolling layers wrap in decode. The
    stream is random, not greedy: with random weights greedy decoding
    repeats one token, whose cached k/v differ by RoPE alone, and a wrong
    slot, crop, roll or pos would hardly move the logits."""
    side = _jax_side(arch)
    jcfg, cfg = side["cfg"], get_smoke(arch)
    if "L" in cfg.mixer_pattern:
        assert S0 + LONG - 1 >= 2 * cfg.sliding_window
    total = S0 + LONG
    prompts, feed = side["prompts"], _prompts(cfg, seed=6, shape=(B, LONG))
    extras = side["extras"]
    jl, jc = side["engine"]._prefill(side["params"], _j_batch(prompts, extras))
    jc = _j_relayout(jcfg, jc, S0, total)
    engine = Engine(cfg, side["tparams"], **CPU)
    j_enc = [x for x in (_enc_out(side["engine"], side["params"], extras, jnp),)
             if x is not None]
    with torch.no_grad():
        t_enc = [x for x in (_enc_out(engine, engine.params, extras, torch),)
                 if x is not None]
        tl, tc = engine._prefill(engine.params, _t_batch(prompts, extras))
        tc = engine._relayout(tc, S0, total)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4, atol=2e-4)
        for t in range(LONG):
            tok = feed[:, t:t + 1]
            jl, jc = side["engine"]._step(side["params"], jnp.asarray(tok),
                                          jnp.asarray(S0 + t, jnp.int32), jc, *j_enc)
            tl, tc = engine._step(engine.params, torch.from_numpy(tok), S0 + t, tc,
                                  *t_enc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-4,
                                       atol=2e-4, err_msg=f"{arch} pos {S0 + t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax(arch):
    """Tokens equal wherever JAX's top-two margin exceeds ``MARGIN``; a row
    is compared up to its first step under the margin (past a near tie the
    two trajectories may part), and most steps must qualify."""
    side = _jax_side(arch)
    out = Engine(get_smoke(arch), side["tparams"], ServeConfig(max_new_tokens=NEW),
                 **CPU).generate(side["prompts"], side["extras"] or None)
    assert out.shape == (B, NEW)
    held = 0
    for b in range(B):
        for t in range(NEW):
            if side["margin"][b, t] <= MARGIN:
                break
            assert out[b, t] == side["out"][b, t], (arch, b, t, out, side["out"])
            held += 1
    assert held > B * NEW // 2, (arch, held, side["margin"])


# -- the port's own contracts ----------------------------------------------------


def _no_cache_rollout(cfg, params, prompts, steps):
    toks = torch.from_numpy(prompts)
    ref = []
    with torch.no_grad():
        for _ in range(steps):
            hidden, _, _ = t_tf.forward(cfg, params, toks)
            nxt = torch.argmax(t_tf.logits_fn(cfg, params, hidden)[:, -1],
                               dim=-1).to(torch.int32)[:, None]
            ref.append(nxt[:, 0].numpy())
            toks = torch.cat([toks, nxt], dim=1)
    return np.stack(ref, axis=1)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b"])
def test_engine_equals_its_no_cache_rollout(arch):
    """Greedy cached decoding reproduces the full forward re-run per token
    (gemma2: prompt + new tokens exceed the window, so each "L" layer is
    cropped to its window and rolled)."""
    cfg = get_smoke(arch)
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(1))
    prompts = _prompts(cfg, seed=1)
    out = Engine(cfg, params, ServeConfig(max_new_tokens=NEW), **CPU).generate(prompts)
    np.testing.assert_array_equal(out, _no_cache_rollout(cfg, params, prompts, NEW))


def test_engine_decode_matches_teacher_forced_forward():
    """Feeding the prompt token by token through the caches gives the
    forward's last-position logits within the reference's decode tolerance,
    and the prefill's within (2e-4, 2e-4)."""
    cfg = get_smoke("tinyllama-1.1b")
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(3))
    toks = torch.from_numpy(_prompts(cfg, seed=3, shape=(1, 8)))
    with torch.no_grad():
        hidden, _, _ = t_tf.forward(cfg, params, toks)
        want = t_tf.logits_fn(cfg, params, hidden)[:, -1]
        pre, _ = api.make_prefill(cfg)(params, {"tokens": toks})
        caches = t_tf.init_caches(cfg, 1, 12, **CPU)
        step = api.make_serve_step(cfg)
        for p in range(8):
            dec, caches = step(params, toks[:, p:p + 1], p, caches)
    np.testing.assert_allclose(pre[:, 0].numpy(), want.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(dec[:, 0].numpy(), want.numpy(), rtol=3e-3, atol=3e-3)


def test_engine_greedy_determinism():
    cfg = get_smoke("gemma2-2b")
    params = _port_params("gemma2-2b")
    engine = Engine(cfg, params, ServeConfig(max_new_tokens=NEW), **CPU)
    prompts = _prompts(cfg, seed=2)
    np.testing.assert_array_equal(engine.generate(prompts), engine.generate(prompts))


def test_engine_sampling_repeats_for_a_seed():
    cfg = get_smoke("tinyllama-1.1b")
    params = _port_params("tinyllama-1.1b")
    prompts = _prompts(cfg, seed=4)
    run = lambda seed: Engine(  # noqa: E731
        cfg, params, ServeConfig(max_new_tokens=NEW, temperature=1.0, seed=seed),
        **CPU).generate(prompts)
    first = run(7)
    np.testing.assert_array_equal(first, run(7))
    assert not np.array_equal(first, run(8))
    assert ((0 <= first) & (first < cfg.vocab)).all()


def test_engine_eos_masking():
    """A slot that hits EOS keeps decoding into a sink but every later
    output position is masked to eos_id."""
    cfg = get_smoke("tinyllama-1.1b")
    params = _port_params("tinyllama-1.1b")
    prompts = _prompts(cfg, seed=5, shape=(2, 8))
    free = Engine(cfg, params, ServeConfig(max_new_tokens=8), **CPU).generate(prompts)
    eos = int(free[0, 2])
    out = Engine(cfg, params, ServeConfig(max_new_tokens=8, eos_id=eos),
                 **CPU).generate(prompts)
    for b in range(out.shape[0]):
        hits = np.flatnonzero(out[b] == eos)
        if hits.size:
            assert (out[b, hits[0]:] == eos).all(), out[b]
            assert (out[b, :hits[0]] == free[b, :hits[0]]).all()
    assert (out[0] == eos).any()


def test_prefill_to_decode_layer_window_contract():
    """An "L" layer converted with the global cache length lands at ITS
    window, in rolled pos % window order; a "G" layer pads to the global
    length."""
    cfg = get_smoke("gemma2-2b")
    w = cfg.sliding_window
    total = 30
    assert w < S0 < total
    k = torch.arange(S0, dtype=torch.float32).reshape(1, S0, 1, 1).expand(1, S0, 2, 4)
    cache = t_attn.KVCache(k=k, v=k)
    out = _prefill_to_decode_caches(cfg, cache, S0, total, mixer="L")
    assert out.k.shape[-3] == w
    want = np.empty(w, np.float32)
    for p in range(S0 - w, S0):
        want[p % w] = p
    np.testing.assert_array_equal(out.k[0, :, 0, 0].numpy(), want)
    out_g = _prefill_to_decode_caches(cfg, cache, S0, total, mixer="G")
    assert out_g.k.shape[-3] == total
    np.testing.assert_array_equal(out_g.k[0, :S0, 0, 0].numpy(), np.arange(S0))
    assert not out_g.k[0, S0:].any()


# -- the launcher and the device rule ----------------------------------------------


def test_launch_serve_restores_a_checkpoint(tmp_path, capsys):
    cfg = get_smoke("gemma2-2b")
    params = _port_params("gemma2-2b")
    t_save.save(str(tmp_path), 3, params, {})
    t_launch.main(["--arch", "gemma2-2b", "--device", "cpu", "--ckpt", str(tmp_path),
                   "--batch", "2", "--prompt-len", "8", "--max-new", "4"])
    printed = capsys.readouterr().out
    assert "served batch=2: generated (2, 4)" in printed
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    want = Engine(cfg, params, ServeConfig(max_new_tokens=4), **CPU).generate(prompts)
    assert str(want) in printed


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_serve_serves_every_family(arch, capsys):
    """The launcher draws the prompts, then the stub frontends' inputs, from
    one seeded generator, as the JAX package's launcher does."""
    cfg = get_smoke(arch)
    t_launch.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                   "--prompt-len", "8", "--max-new", "3"])
    printed = capsys.readouterr().out
    assert "served batch=2: generated (2, 3)" in printed
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
    extras = {}
    if cfg.vlm is not None:
        extras["patch_embeds"] = rng.standard_normal(
            (2, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        extras["enc_frames"] = rng.standard_normal(
            (2, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    params = t_tf.init_params(cfg, torch.Generator().manual_seed(0))
    want = Engine(cfg, params, ServeConfig(max_new_tokens=3), **CPU).generate(
        prompts, extras or None)
    assert str(want) in printed


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke("gemma2-2b")
    params = t_tf.param_template(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tf.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--arch", "gemma2-2b", "--max-new", "2"])
