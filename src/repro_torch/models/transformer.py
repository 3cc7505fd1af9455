"""LM assembly (port of ``src/repro/models/transformer.py``): parameter
construction, the layer stack and the training forward with the chunked
cross-entropy loss, for the dense and MoE families.

The parameter tree keeps the JAX package's structure: a dict whose layer
groups are stacked on a leading ``(G, ...)`` axis (as ``jax.vmap`` stacks
``group_params``), attention, MLP and MoE weights in the ``AttnParams``,
``MLPParams`` and ``MoEParams`` NamedTuples, so its flattened key paths
(``repro_torch.tree.flatten_with_path``) are those of
``repro.ckpt.save._flatten`` letter for letter, e.g.
``groups/l0/attn/.wq``, ``groups/l0/ffn/.w_gate``. The scan over layer
groups is a Python loop over the unbound group slices; ``remat="layer"``
runs each checkpoint span under ``torch.utils.checkpoint`` (memory only,
the values are the same). The MoE layers' aux losses are summed as the
reference sums them: per group over its layers, then over the groups in
order, then the remainder layers.

Ported kinds: mixers 'G' and 'L' (attention with ``window =
cfg.sliding_window``), ffn 'D', 'E' and 'N', in the three modes of the
reference's ``_apply_mixer``: ``train``, ``prefill`` (the full pass plus
each layer's ``KVCache`` of the roped k and the v of the whole prompt) and
``decode`` (one token at ``pos`` against the caches of ``init_caches``,
written in place). The cache tree is the reference's, ``{"groups":
{"l{i}": KVCache stacked on a leading (n_groups,) axis}, "rem{r}":
KVCache}``; ``decode_step`` is one token of cached decoding. Mixers 'M'
and 'R', the encoder and the VLM stub raise ``NotImplementedError``
(``ROADMAP.md`` queue 1, item 10).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models import moe as moem
from repro_torch.models.common import embed, normal_init, rms_norm, softcap

_FAMILIES = "ROADMAP.md queue 1, item 10"


def _unported(what: str):
    return NotImplementedError(f"{what} waits for its model family's port "
                               f"({_FAMILIES})")


# ---------------------------------------------------------------------------
# Parameter construction
# ---------------------------------------------------------------------------

# make(shape, dtype) -> a normal(0, 0.02) draw; zeros(shape, dtype)
Maker = Callable[[Tuple[int, ...], torch.dtype], torch.Tensor]


def _init_attn(make: Maker, cfg: ModelConfig, dtype) -> attn.AttnParams:
    D, H, Kv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    return attn.AttnParams(
        wq=make((D, H * Dh), dtype), wk=make((D, Kv * Dh), dtype),
        wv=make((D, Kv * Dh), dtype), wo=make((H * Dh, D), dtype))


def _init_mlp(make: Maker, zeros: Maker, cfg: ModelConfig, dtype) -> mlpm.MLPParams:
    D, F = cfg.d_model, cfg.d_ff
    gated = cfg.activation in ("swiglu", "geglu")
    return mlpm.MLPParams(
        w_in=make((D, F), dtype),
        w_gate=make((D, F), dtype) if gated else zeros((1, 1), dtype),
        w_out=make((F, D), dtype))


def _init_moe(make: Maker, cfg: ModelConfig, dtype) -> moem.MoEParams:
    D = cfg.d_model
    E, F = cfg.moe.n_experts, cfg.moe.d_ff_expert
    return moem.MoEParams(
        w_router=make((D, E), torch.float32),
        w_gate=make((E, D, F), dtype), w_in=make((E, D, F), dtype),
        w_out=make((E, F, D), dtype))


def _init_layer(make: Maker, zeros: Maker, cfg: ModelConfig, mixer: str,
                ffn: str, dtype) -> Dict:
    D = cfg.d_model
    lp: Dict[str, Any] = {"norm1": zeros((D,), dtype)}
    if mixer in ("G", "L"):
        lp["attn"] = _init_attn(make, cfg, dtype)
    else:
        raise _unported(f"mixer {mixer!r}")
    if ffn != "N":
        lp["norm2"] = zeros((D,), dtype)
        lp["ffn"] = (_init_moe(make, cfg, dtype) if ffn == "E"
                     else _init_mlp(make, zeros, cfg, dtype))
    if cfg.post_norms:
        lp["post_norm1"] = zeros((D,), dtype)
        if ffn != "N":
            lp["post_norm2"] = zeros((D,), dtype)
    return lp


def _groups(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(period, n_groups, n_rem): layers = n_groups*period + n_rem."""
    if not cfg.scan_layers:
        return 1, 0, cfg.n_layers
    period = cfg.pattern_period
    return period, cfg.n_layers // period, cfg.n_layers % period


def _build(cfg: ModelConfig, make: Maker, zeros: Maker) -> Dict:
    if cfg.encoder is not None or cfg.vlm is not None:
        raise _unported("the encoder / VLM stub")
    dtype = cfg.torch_dtype
    period, n_groups, n_rem = _groups(cfg)
    params: Dict[str, Any] = {
        "embed": make((cfg.vocab, cfg.d_model), dtype),
        "final_norm": zeros((cfg.d_model,), dtype),
    }
    if n_groups:
        groups = [{f"l{i}": _init_layer(make, zeros, cfg, cfg.mixer_at(i),
                                        cfg.ffn_at(i), dtype)
                   for i in range(period)} for _ in range(n_groups)]
        params["groups"] = tree.map(lambda *xs: torch.stack(xs), *groups)
    for r in range(n_rem):
        li = n_groups * period + r
        params[f"rem{r}"] = _init_layer(make, zeros, cfg, cfg.mixer_at(li),
                                        cfg.ffn_at(li), dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = make((cfg.d_model, cfg.vocab), dtype)
    return params


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """Random parameters drawn from ``gen`` on its device (N(0, 0.02^2)
    weights, zero norm scales). The draws differ from the JAX package's
    (its keys are JAX's); shapes, dtypes and paths are the same."""
    dev = gen.device
    return _build(cfg, lambda s, dt: normal_init(gen, s, dt),
                  lambda s, dt: torch.zeros(s, dtype=dt, device=dev))


def param_template(cfg: ModelConfig) -> Dict:
    """The parameter tree on the meta device: shapes, dtypes and paths
    without storage."""
    meta = lambda s, dt: torch.empty(s, dtype=dt, device="meta")  # noqa: E731
    return _build(cfg, meta, meta)


# ---------------------------------------------------------------------------
# Layer application
# ---------------------------------------------------------------------------


def _apply_mixer(cfg: ModelConfig, mixer: str, lp: Dict, x: torch.Tensor, *,
                 positions, mode: str, cache, pos):
    """Returns ``(out, new_cache)``: the k/v of the whole sequence in
    prefill mode, ``cache`` written at ``pos`` in decode mode, None in
    train mode."""
    if mixer not in ("G", "L"):
        raise _unported(f"mixer {mixer!r}")
    window = cfg.sliding_window if mixer == "L" else None
    p: attn.AttnParams = lp["attn"]
    B, S, _ = x.shape
    H, Kv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    if mode != "decode" and S >= cfg.attn_chunk_threshold:
        raise attn.chunked_unported()
    q, k, v = attn.project_qkv(p, x, n_heads=H, n_kv=Kv, head_dim=Dh,
                               rope_theta=cfg.rope_theta, positions=positions)
    if mode == "decode":
        new_cache = attn.cache_update(cache, k, v, pos)
        o = attn.decode_attention(q, new_cache, pos, n_kv=Kv, window=window,
                                  cap=cfg.attn_softcap)
    else:
        o = attn.full_attention(q, k, v, n_kv=Kv, causal=True, window=window,
                                cap=cfg.attn_softcap)
        new_cache = attn.KVCache(k=k, v=v) if mode == "prefill" else None
    return o.reshape(B, S, H * Dh) @ p.wo, new_cache


def _apply_layer(cfg: ModelConfig, mixer: str, ffn: str, lp: Dict,
                 x: torch.Tensor, *, positions, mode: str, cache, pos):
    """Returns ``(x, new_cache, aux_loss)``."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    h, new_cache = _apply_mixer(cfg, mixer, lp, h, positions=positions,
                                mode=mode, cache=cache, pos=pos)
    if cfg.post_norms:
        h = rms_norm(h, lp["post_norm1"], cfg.norm_eps)
    x = x + h
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


def _apply_stack(cfg: ModelConfig, params, x: torch.Tensor, *, positions,
                 mode: str, caches, pos):
    """Returns ``(x, new_caches, aux_total)``; ``new_caches`` is None in
    train mode. Decode writes into ``caches`` in place and returns them."""
    period, n_groups, n_rem = _groups(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {"groups": None}

    def group_body(x, gp, gcache):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        out = {}
        for i in range(period):
            c = gcache[f"l{i}"] if gcache is not None else None
            x, out[f"l{i}"], a = _apply_layer(
                cfg, cfg.mixer_at(i), cfg.ffn_at(i), gp[f"l{i}"], x,
                positions=positions, mode=mode, cache=c, pos=pos)
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
            new_caches["groups"] = (
                caches["groups"] if mode == "decode"
                else tree.map(lambda *xs: torch.stack(xs), *per_group))
    for r in range(n_rem):
        li = n_groups * period + r
        c = caches[f"rem{r}"] if mode == "decode" else None
        x, new_caches[f"rem{r}"], a = _apply_layer(
            cfg, cfg.mixer_at(li), cfg.ffn_at(li), params[f"rem{r}"], x,
            positions=positions, mode=mode, cache=c, pos=pos)
        aux_total = aux_total + a
    return x, (None if mode == "train" else new_caches), aux_total


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params, tokens: torch.Tensor, *,
            patch_embeds: Optional[torch.Tensor] = None,
            enc_frames: Optional[torch.Tensor] = None,
            mode: str = "train", caches=None, pos=None):
    """Returns (hidden (B,S,D), new_caches, aux_loss). ``mode`` is
    ``train`` (no caches), ``prefill`` (returns each layer's cache of the
    whole sequence) or ``decode`` (``caches`` from ``init_caches``, the
    tokens at position ``pos``)."""
    if patch_embeds is not None or enc_frames is not None:
        raise _unported("the encoder / VLM stub")
    x = embed(tokens, params["embed"], scale=cfg.embed_scale)
    S = tokens.shape[1]
    positions = (torch.arange(S, device=x.device)[None] if pos is None
                 else torch.full((1, S), pos, device=x.device))
    x, new_caches, aux = _apply_stack(cfg, params, x, positions=positions,
                                      mode=mode, caches=caches, pos=pos)
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
    (sliding-window layers get a rolling cache of window size); raises
    without CUDA unless ``device="cpu"``."""
    if cfg.encoder is not None or cfg.vlm is not None:
        raise _unported("the encoder / VLM stub")
    dev = resolve_device(device)
    period, n_groups, n_rem = _groups(cfg)
    shape = (n_groups,) if n_groups else ()

    def layer_cache(mixer, lead=()):
        if mixer == "G":
            S_c = seq_len
        elif mixer == "L":
            S_c = min(cfg.sliding_window, seq_len)
        else:
            raise _unported(f"mixer {mixer!r}")
        zeros = lambda: torch.zeros(  # noqa: E731
            lead + (batch, S_c, cfg.n_kv_heads, cfg.hdim),
            dtype=cfg.torch_dtype, device=dev)
        return attn.KVCache(k=zeros(), v=zeros())

    caches: Dict[str, Any] = {}
    if n_groups:
        caches["groups"] = {f"l{i}": layer_cache(cfg.mixer_at(i), shape)
                            for i in range(period)}
    for r in range(n_rem):
        caches[f"rem{r}"] = layer_cache(cfg.mixer_at(n_groups * period + r))
    return caches


def decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor, pos: int):
    """One token of cached decoding: ``token`` (B, 1) at position ``pos``.
    Returns (logits (B,1,V), new_caches); the caches are written in place."""
    x, new_caches, _ = forward(cfg, params, token, mode="decode",
                               caches=caches, pos=pos)
    return logits_fn(cfg, params, x), new_caches
