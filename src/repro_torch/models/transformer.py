"""LM assembly (port of ``src/repro/models/transformer.py``): parameter
construction, the layer stack, the training forward with the chunked
cross-entropy loss, prefill and cached decode, for every family of the JAX
package.

The parameter tree keeps the JAX package's structure: a dict whose layer
groups are stacked on a leading ``(G, ...)`` axis (as ``jax.vmap`` stacks
``group_params``), the weights in the ``AttnParams``, ``MLPParams``,
``MoEParams``, ``SSMParams`` and ``RGLRUParams`` NamedTuples, the
encoder's layers stacked on a leading ``(n_enc_layers, ...)`` axis, so
its flattened key paths (``repro_torch.tree.flatten_with_path``) are those
of ``repro.ckpt.save._flatten`` letter for letter, e.g.
``groups/l0/attn/.wq``, ``groups/l0/ssm/.A_log``, ``enc_layers/ffn/.w_in``.
The scan over layer groups is a Python loop over the unbound group
slices; ``remat="layer"`` runs each checkpoint span under
``torch.utils.checkpoint`` (memory only, the values are the same). The
MoE layers' aux losses are summed as the reference sums them: per group
over its layers, then over the groups in order, then the remainder layers.

Kinds: mixers 'G' and 'L' (attention with ``window =
cfg.sliding_window``; streaming ``chunked_attention`` at S >=
``cfg.attn_chunk_threshold``), 'M' (Mamba2 SSD) and 'R' (RG-LRU); ffn 'D',
'E' and 'N'; cross-attention to the encoder's output in every decoder
layer of an encoder-decoder config; the VLM stub's patch embeddings over
the first token positions. Three modes, as in the reference's
``_apply_mixer``: ``train``, ``prefill`` (the full pass plus each layer's
cache: the roped k and the v of the whole prompt, or the recurrent state
after it) and ``decode`` (one token at ``pos`` against the caches of
``init_caches``). The cache tree is the reference's, ``{"groups": {"l{i}":
KVCache | SSMState | RGLRUState stacked on a leading (n_groups,) axis},
"rem{r}": ...}``. Decode writes every cache in place (a KV cache at its
slot, a recurrent state over its old value) and returns the tree it was
given; ``decode_step`` is one token of cached decoding.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models import rglru as rglrum
from repro_torch.models import ssm as ssmm
from repro_torch.models.common import embed, normal_init, rms_norm, rope, softcap


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

class Init(NamedTuple):
    """How ``_build`` makes leaves: ``normal(shape, dtype, scale)`` a
    N(0, scale^2) draw, ``zeros(shape, dtype)``, and ``device`` for the
    reference's constant leaves (the meta device for a template)."""
    normal: Callable[..., torch.Tensor]
    zeros: Callable[[Tuple[int, ...], torch.dtype], torch.Tensor]
    device: Any


def _init_attn(mk: Init, cfg: ModelConfig, dtype) -> attn.AttnParams:
    D, H, Kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    return attn.AttnParams(
        wq=mk.normal((D, H * Dh), dtype), wk=mk.normal((D, Kv * Dh), dtype),
        wv=mk.normal((D, Kv * Dh), dtype), wo=mk.normal((H * Dh, D), dtype))


def _init_mlp(mk: Init, cfg: ModelConfig, dtype) -> mlpm.MLPParams:
    D, F = cfg.d_model, cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    return mlpm.MLPParams(
        w_in=mk.normal((D, F), dtype),
        w_gate=mk.normal((D, F), dtype) if gated else mk.zeros((1, 1), dtype),
        w_out=mk.normal((F, D), dtype))


def _init_moe(mk: Init, cfg: ModelConfig, dtype) -> moem.MoEParams:
    D = cfg.d_model
    E, F = cfg.moe.n_experts, cfg.moe.d_ff_expert
    return moem.MoEParams(
        w_router=mk.normal((D, E), torch.float32),
        w_gate=mk.normal((E, D, F), dtype), w_in=mk.normal((E, D, F), dtype),
        w_out=mk.normal((E, F, D), dtype))


def _init_ssm(mk: Init, cfg: ModelConfig, dtype) -> ssmm.SSMParams:
    s, D = cfg.ssm, cfg.d_model
    d_inner, H, _, G, N = ssmm._dims(D, s)
    conv_dim = d_inner + 2 * G * N
    f32 = dict(dtype=torch.float32, device=mk.device)
    return ssmm.SSMParams(
        w_in=mk.normal((D, 2 * d_inner + 2 * G * N + H), dtype),
        conv_w=mk.normal((s.conv_width, conv_dim), dtype, 0.1),
        A_log=torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        Dskip=torch.ones((H,), **f32),
        dt_bias=torch.zeros((H,), **f32),
        norm_scale=mk.zeros((d_inner,), dtype),
        w_out=mk.normal((d_inner, D), dtype))


def _init_rglru(mk: Init, cfg: ModelConfig, dtype) -> rglrum.RGLRUParams:
    r, D = cfg.rglru, cfg.d_model
    W = r.lru_width or D
    return rglrum.RGLRUParams(
        w_in=mk.normal((D, 2 * W), dtype),
        conv_w=mk.normal((r.conv_width, W), dtype, 0.1),
        w_a=mk.normal((W, W), dtype),
        b_a=mk.zeros((W,), dtype),
        w_x=mk.normal((W, W), dtype),
        b_x=mk.zeros((W,), dtype),
        a_param=torch.full((W,), 0.5, dtype=torch.float32, device=mk.device),
        w_out=mk.normal((W, D), dtype))


def _init_layer(mk: Init, cfg: ModelConfig, mixer: str, ffn: str, cross: bool,
                dtype) -> Dict:
    D = cfg.d_model
    lp: Dict[str, Any] = {"norm1": mk.zeros((D,), dtype)}
    if mixer in ("G", "L"):
        lp["attn"] = _init_attn(mk, cfg, dtype)
    elif mixer == "M":
        lp["ssm"] = _init_ssm(mk, cfg, dtype)
    elif mixer == "R":
        lp["lru"] = _init_rglru(mk, cfg, dtype)
    else:
        raise ValueError(mixer)
    if cross:
        lp["cross_norm"] = mk.zeros((D,), dtype)
        lp["cross"] = _init_attn(mk, cfg, dtype)
    if ffn != "N":
        lp["norm2"] = mk.zeros((D,), dtype)
        lp["ffn"] = (_init_moe(mk, cfg, dtype) if ffn == "E"
                     else _init_mlp(mk, cfg, dtype))
    if cfg.post_norms:
        lp["post_norm1"] = mk.zeros((D,), dtype)
        if ffn != "N":
            lp["post_norm2"] = mk.zeros((D,), dtype)
    return lp


def _groups(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(period, n_groups, n_rem): layers = n_groups*period + n_rem."""
    if not cfg.scan_layers:
        return 1, 0, cfg.n_layers
    period = cfg.pattern_period
    return period, cfg.n_layers // period, cfg.n_layers % period


def _stack(trees: list):
    return tree.map(lambda *xs: torch.stack(xs), *trees)


def _build(cfg: ModelConfig, mk: Init) -> Dict:
    dtype = cfg.torch_dtype
    period, n_groups, n_rem = _groups(cfg)
    cross = cfg.encoder is not None
    params: Dict[str, Any] = {
        "embed": mk.normal((cfg.vocab, cfg.d_model), dtype),
        "final_norm": mk.zeros((cfg.d_model,), dtype),
    }
    if n_groups:
        params["groups"] = _stack([
            {f"l{i}": _init_layer(mk, cfg, cfg.mixer_at(i), cfg.ffn_at(i),
                                  cross, dtype)
             for i in range(period)} for _ in range(n_groups)])
    for r in range(n_rem):
        li = n_groups * period + r
        params[f"rem{r}"] = _init_layer(mk, cfg, cfg.mixer_at(li),
                                        cfg.ffn_at(li), cross, dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = mk.normal((cfg.d_model, cfg.vocab), dtype)
    if cfg.encoder is not None:
        params["enc_pos"] = mk.normal((cfg.encoder.n_frames, cfg.d_model), dtype)
        params["enc_final_norm"] = mk.zeros((cfg.d_model,), dtype)
        params["enc_layers"] = _stack([
            _init_layer(mk, cfg, "G", "D", False, dtype)
            for _ in range(cfg.encoder.n_layers)])
    return params


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """Random parameters drawn from ``gen`` on its device (N(0, 0.02^2)
    weights, 0.1 for the conv kernels, zero norm scales, the reference's
    constants for A_log, Dskip, dt_bias and a_param). The draws differ from
    the JAX package's (its keys are JAX's); shapes, dtypes and paths are the
    same."""
    dev = gen.device
    return _build(cfg, Init(
        normal=lambda s, dt, scale=0.02: normal_init(gen, s, dt, scale),
        zeros=lambda s, dt: torch.zeros(s, dtype=dt, device=dev), device=dev))


def param_template(cfg: ModelConfig) -> Dict:
    """The parameter tree on the meta device: shapes, dtypes and paths
    without storage."""
    meta = lambda s, dt, *_: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    return _build(cfg, Init(normal=meta, zeros=meta, device="meta"))


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _apply_mixer(cfg: ModelConfig, mixer: str, lp: Dict, x: torch.Tensor, *,
                 positions, mode: str, cache, pos):
    """Returns ``(out, new_cache)``: in prefill mode the k/v of the whole
    sequence or the recurrent state after it, in decode mode the KV cache
    written at ``pos`` or the new recurrent state, None in train mode."""
    B, S, _ = x.shape
    if mixer == "M":
        if mode == "train":
            return ssmm.ssm_forward(lp["ssm"], x, d_model=cfg.d_model,
                                    ssm_cfg=cfg.ssm), None
        return ssmm.ssm_forward(lp["ssm"], x, d_model=cfg.d_model,
                                ssm_cfg=cfg.ssm, state=cache, return_state=True)
    if mixer == "R":
        if mode == "train":
            return rglrum.rglru_forward(lp["lru"], x), None
        return rglrum.rglru_forward(lp["lru"], x, state=cache, return_state=True)
    if mixer not in ("G", "L"):
        raise ValueError(mixer)
    window = cfg.sliding_window if mixer == "L" else None
    p: attn.AttnParams = lp["attn"]
    H, Kv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    if mode == "decode":
        q = rope((x @ p.wq).reshape(B, 1, H, Dh), positions, cfg.rope_theta)
        k = rope((x @ p.wk).reshape(B, 1, Kv, Dh), positions, cfg.rope_theta)
        v = (x @ p.wv).reshape(B, 1, Kv, Dh)
        new_cache = attn.cache_update(cache, k, v, pos)
        o = attn.decode_attention(q, new_cache, pos, n_kv=Kv, window=window,
                                  cap=cfg.attn_softcap)
        return o.reshape(B, 1, H * Dh) @ p.wo, new_cache
    out, k, v = attn.attn_forward(
        p, x, n_heads=H, n_kv=Kv, head_dim=Dh, rope_theta=cfg.rope_theta,
        causal=True, window=window, cap=cfg.attn_softcap, positions=positions,
        chunked=S >= cfg.attn_chunk_threshold, q_chunk=cfg.attn_chunk,
        kv_chunk=cfg.attn_chunk, schedule=cfg.attn_schedule, return_kv=True)
    return out, (attn.KVCache(k=k, v=v) if mode == "prefill" else None)


def _apply_layer(cfg: ModelConfig, mixer: str, ffn: str, lp: Dict,
                 x: torch.Tensor, *, positions, mode: str, cache, pos,
                 enc_out=None):
    """Returns ``(x, new_cache, aux_loss)``."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    h, new_cache = _apply_mixer(cfg, mixer, lp, h, positions=positions,
                                mode=mode, cache=cache, pos=pos)
    if cfg.post_norms:
        h = rms_norm(h, lp["post_norm1"], cfg.norm_eps)
    x = x + h
    if "cross" in lp and enc_out is not None:
        # non-causal, no RoPE and no softcap, k and v from the encoder
        hc = rms_norm(x, lp["cross_norm"], cfg.norm_eps)
        p: attn.AttnParams = lp["cross"]
        B, F = enc_out.shape[:2]
        k = (enc_out @ p.wk).reshape(B, F, cfg.n_kv_heads, cfg.hdim)
        v = (enc_out @ p.wv).reshape(B, F, cfg.n_kv_heads, cfg.hdim)
        x = x + attn.attn_forward(
            p, hc, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hdim,
            rope_theta=cfg.rope_theta, causal=False, use_rope=False,
            kv_override=(k, v))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "N":
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        if ffn == "E":
            h2, aux = moem.moe_forward(
                lp["ffn"], h2, top_k=cfg.moe.top_k,
                capacity_factor=cfg.moe.capacity_factor,
                activation=cfg.activation, shards=cfg.moe_shards)
        else:
            h2 = mlpm.mlp_forward(lp["ffn"], h2, cfg.activation)
        if cfg.post_norms:
            h2 = rms_norm(h2, lp["post_norm2"], cfg.norm_eps)
        x = x + h2
    return x, new_cache, aux


def _unbind_groups(stacked, n_groups: int) -> list:
    """The per-group slices of a tree stacked on a leading (n_groups,) axis:
    one ``unbind`` a leaf (views; a parameter's gradient is one stack)."""
    slices = {path: torch.unbind(leaf)
              for path, leaf in tree.flatten_with_path(stacked)}
    return [tree.unflatten_like(stacked, {p: s[g] for p, s in slices.items()})
            for g in range(n_groups)]


def _write_back(cache, new) -> None:
    """Decode's in-place contract: a recurrent state comes back as new
    tensors, copied over the cache it was given (a view into the stacked
    group caches); a KV cache comes back as the cache itself."""
    if new is not cache:
        for dst, src in zip(cache, new):
            dst.copy_(src)


def _apply_stack(cfg: ModelConfig, params, x: torch.Tensor, *, positions,
                 mode: str, caches, pos, enc_out=None):
    """Returns ``(x, new_caches, aux_total)``; ``new_caches`` is None in
    train mode. Decode writes into ``caches`` in place and returns them."""
    period, n_groups, n_rem = _groups(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {"groups": None}

    def layer(li: int, lp, x, cache):
        x, nc, a = _apply_layer(cfg, cfg.mixer_at(li), cfg.ffn_at(li), lp, x,
                                positions=positions, mode=mode, cache=cache,
                                pos=pos, enc_out=enc_out)
        if mode == "decode":
            _write_back(cache, nc)
            nc = cache
        return x, nc, a

    def group_body(x, gp, gcache):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        out = {}
        for i in range(period):
            c = gcache[f"l{i}"] if gcache is not None else None
            x, out[f"l{i}"], a = layer(i, gp[f"l{i}"], x, c)
            aux = aux + a
        return x, out, aux

    if n_groups:
        K = cfg.remat_group if (mode == "train" and n_groups % cfg.remat_group == 0) else 1
        gps = _unbind_groups(params["groups"], n_groups)
        gcs = (_unbind_groups(caches["groups"], n_groups) if mode == "decode"
               else [None] * n_groups)
        remat = cfg.remat == "layer" and mode == "train" and torch.is_grad_enabled()

        def span(x, *chunk):
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for gp in chunk:
                x, _, a = group_body(x, gp, None)
                aux = aux + a
            return x, aux

        if mode == "train":
            for g0 in range(0, n_groups, K):
                chunk = gps[g0:g0 + K]
                if remat:
                    x, aux = checkpoint(span, x, *chunk, use_reentrant=False)
                else:
                    x, aux = span(x, *chunk)
                aux_total = aux_total + aux
        else:
            per_group = []
            for gp, gc in zip(gps, gcs):
                x, nc, a = group_body(x, gp, gc)
                per_group.append(nc)
                aux_total = aux_total + a
            new_caches["groups"] = (caches["groups"] if mode == "decode"
                                    else _stack(per_group))
    for r in range(n_rem):
        li = n_groups * period + r
        c = caches[f"rem{r}"] if mode == "decode" else None
        x, new_caches[f"rem{r}"], a = layer(li, params[f"rem{r}"], x, c)
        aux_total = aux_total + a
    return x, (None if mode == "train" else new_caches), aux_total


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def encode(cfg: ModelConfig, params, frames: torch.Tensor) -> torch.Tensor:
    """Whisper-style encoder over precomputed frame embeddings (stub
    frontend): frames (B, F, D), taken in the parameters' dtype (the JAX
    package's input specs give them in the model's dtype). Non-causal
    attention without RoPE, the MLP's activation fixed to gelu."""
    pos_emb = params["enc_pos"]
    x = frames.to(pos_emb.dtype) + pos_emb[None]
    for lp in _unbind_groups(params["enc_layers"], cfg.encoder.n_layers):
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        x = x + attn.attn_forward(
            lp["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.hdim, rope_theta=cfg.rope_theta, causal=False,
            use_rope=False)
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + mlpm.mlp_forward(lp["ffn"], h2, "gelu")
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            patch_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            mode: str = "train", caches=None, pos=None):
    """Returns (hidden (B,S,D), new_caches, aux_loss). ``mode`` is
    ``train`` (no caches), ``prefill`` (returns each layer's cache of the
    whole sequence) or ``decode`` (``caches`` from ``init_caches``, the
    tokens at position ``pos``). ``patch_embeds`` (B, n_patches, D) take
    the place of the first token embeddings; ``enc_frames`` (B, F, D) go
    through ``encode`` for the cross-attention layers."""
    x = embed(tokens, params["embed"], scale=cfg.embed_scale)
    if patch_embeds is not None:
        n = patch_embeds.shape[1]
        x = torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)
    enc_out = None
    if cfg.encoder is not None and enc_frames is not None:
        enc_out = encode(cfg, params, enc_frames)
    S = tokens.shape[1]
    positions = (torch.arange(S, device=x.device)[None] if pos is None
                 else torch.full((1, S), pos, device=x.device))
    x, new_caches, aux = _apply_stack(cfg, params, x, positions=positions,
                                      mode=mode, caches=caches, pos=pos,
                                      enc_out=enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_caches, aux


def _table(cfg: ModelConfig, params) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"].T


def logits_fn(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    logits = hidden @ _table(cfg, params).to(hidden.dtype).T
    return softcap(logits.float(), cfg.logit_softcap)


def loss_fn(cfg: ModelConfig, params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Chunked-CE training loss. batch: tokens (B,S), labels (B,S)."""
    hidden, _, aux = forward(
        cfg, params, batch["tokens"],
        patch_embeds=batch.get("patch_embeds"),
        enc_frames=batch.get("enc_frames"), mode="train")
    B, S, D = hidden.shape
    table = _table(cfg, params)

    N = B * S
    hf = hidden.reshape(N, D)
    lf = batch["labels"].reshape(N).long()
    chunk = min(cfg.loss_chunk, N)
    n_chunks = max(N // chunk, 1)
    assert N % chunk == 0 or n_chunks == 1, (N, chunk)

    def ce_chunk(h, lab):
        logits = h @ table.to(h.dtype).T
        logits = softcap(logits.float(), cfg.logit_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        # gather's gradient is deterministic on CUDA under
        # torch.use_deterministic_algorithms(True)
        picked = torch.gather(logits, -1, lab[:, None])[:, 0]
        return torch.sum(lse - picked)

    if n_chunks == 1:
        total = ce_chunk(hf, lf)
    else:
        total = torch.zeros((), dtype=torch.float32, device=hf.device)
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            total = total + ce_chunk(hf[sl], lf[sl])
    loss = total / N + 0.01 * aux
    return loss, {"ce": total / N, "aux": aux}


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, device="cuda"):
    """Zero caches for decode at cache length ``seq_len`` on ``device``
    (sliding-window layers get a rolling cache of window size, 'M' and 'R'
    layers their recurrent state: h in float32, the conv tail in the
    model's dtype); raises without CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    period, n_groups, n_rem = _groups(cfg)
    shape = (n_groups,) if n_groups else ()
    dtype = cfg.torch_dtype

    def layer_cache(mixer, lead=()):
        zeros = lambda *s, dt=dtype: torch.zeros(  # noqa: E731
            lead + (batch,) + s, dtype=dt, device=dev)
        if mixer == "M":
            s = cfg.ssm
            d_inner, H, P, G, N = ssmm._dims(cfg.d_model, s)
            return ssmm.SSMState(h=zeros(H, P, N, dt=torch.float32),
                                 conv=zeros(s.conv_width - 1, d_inner + 2 * G * N))
        if mixer == "R":
            W = cfg.rglru.lru_width or cfg.d_model
            return rglrum.RGLRUState(h=zeros(W, dt=torch.float32),
                                     conv=zeros(cfg.rglru.conv_width - 1, W))
        if mixer == "G":
            S_c = seq_len
        elif mixer == "L":
            S_c = min(cfg.sliding_window, seq_len)
        else:
            raise ValueError(mixer)
        return attn.KVCache(k=zeros(S_c, cfg.n_kv_heads, cfg.hdim),
                            v=zeros(S_c, cfg.n_kv_heads, cfg.hdim))

    caches: Dict[str, Any] = {}
    if n_groups:
        caches["groups"] = {f"l{i}": layer_cache(cfg.mixer_at(i), shape)
                            for i in range(period)}
    for r in range(n_rem):
        caches[f"rem{r}"] = layer_cache(cfg.mixer_at(n_groups * period + r))
    return caches


def decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor, pos: int,
                *, enc_out: Optional[torch.Tensor] = None):
    """One token of cached decoding: ``token`` (B, 1) at position ``pos``
    (``enc_out`` the encoder's output for the cross-attention layers).
    Returns (logits (B,1,V), new_caches); the caches are written in place."""
    x = embed(token, params["embed"], scale=cfg.embed_scale)
    x, new_caches, _ = _apply_stack(
        cfg, params, x, positions=torch.full((1, 1), pos, device=x.device),
        mode="decode", caches=caches, pos=pos, enc_out=enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x), new_caches
