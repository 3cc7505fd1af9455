"""Batched serving engine (port of ``src/repro/serve/engine.py``):
prefill -> cached decode with sampling.

Static-batch engine (slots = batch rows): prefill a batch of prompts, then
step all slots together; finished slots (EOS or max length) keep decoding
into a sink but are masked from the outputs. Sliding-window layers convert
the prefill cache into rolling form (roll by S0 mod window) so decode's
``pos % window`` addressing lines up; SSM and LRU states pass through as
the prefill left them. An encoder-decoder model encodes its frames once
and passes the encoder's output to every decode step; a VLM's patch
embeddings go to the prefill.

The engine runs on its device (``Engine(..., device=)``, the card unless
the caller asks for the CPU; the params are moved there) and returns
numpy. Greedy decoding (``temperature == 0``) is the path held against the
JAX package. At ``temperature > 0`` the draws come from a
``torch.Generator`` on that device seeded with ``ServeConfig.seed``
(Gumbel-max over ``logits / temperature``); they differ from
``jax.random.categorical``'s by construction, and repeat for one seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import api
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0   # 0 = greedy
    eos_id: int = -1           # -1 = never stop early
    cache_len: int = 0         # 0 = prompt_len + max_new_tokens
    seed: int = 0


def _prefill_to_decode_caches(cfg: ModelConfig, cache, prompt_len: int,
                              cache_len: int, mixer: str = "G"):
    """Convert a full prefill KV cache to decode layout (an SSM or LRU state
    passes through as it is): pad/crop the layer
    to ITS decode cache length — ``_layer_cache_len(cfg, mixer, cache_len)``,
    the sliding window for "L" layers, the global ``cache_len`` otherwise.
    Cropped (rolling) layers keep the last ``window`` entries rolled into
    ``pos % window`` order — decode's rolling addressing and masking assume
    ``S_cache == window``. The sequence axis is -3 ((..., S, Kv, Dh)); a
    leading group axis may be present."""
    if not isinstance(cache, attn.KVCache):
        return cache
    tgt = _layer_cache_len(cfg, mixer, cache_len)
    S_full = cache.k.shape[-3]

    def conv(x):
        if tgt >= S_full:
            out = x.new_zeros(x.shape[:-3] + (tgt,) + x.shape[-2:])
            out[..., :S_full, :, :] = x
            return out
        # rolling layer: keep the last `tgt` entries at pos % tgt slots
        return torch.roll(x[..., S_full - tgt:, :, :], prompt_len % tgt, dims=-3)

    return attn.KVCache(k=conv(cache.k), v=conv(cache.v))


def _layer_cache_len(cfg: ModelConfig, mixer: str, total_len: int) -> int:
    if mixer == "L":
        return min(cfg.sliding_window, total_len)
    return total_len


class Engine:
    def __init__(self, cfg: ModelConfig, params, scfg: Optional[ServeConfig] = None,
                 *, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree.map(lambda x: x.to(self.device), params)
        self.scfg = scfg or ServeConfig()
        self._prefill = api.make_prefill(cfg)
        self._step = api.make_serve_step(cfg)

    def _relayout(self, caches, S0: int, total: int):
        """Re-key the prefill caches into decode layout per layer kind."""
        cfg = self.cfg
        period, n_groups, n_rem = tf._groups(cfg)
        out = {}
        if caches.get("groups") is not None:
            out["groups"] = {
                f"l{i}": _prefill_to_decode_caches(
                    cfg, caches["groups"][f"l{i}"], S0, total, cfg.mixer_at(i))
                for i in range(period)}
        for r in range(n_rem):
            out[f"rem{r}"] = _prefill_to_decode_caches(
                cfg, caches[f"rem{r}"], S0, total,
                cfg.mixer_at(n_groups * period + r))
        return out

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, extras: Optional[Dict] = None) -> np.ndarray:
        """prompts: (B, S0) int32; ``extras`` the numpy ``patch_embeds``
        (B, n_patches, D) of a VLM or ``enc_frames`` (B, F, D) of an
        encoder-decoder model. Returns (B, max_new_tokens)."""
        cfg, scfg, dev = self.cfg, self.scfg, self.device
        B, S0 = prompts.shape
        total = scfg.cache_len or (S0 + scfg.max_new_tokens)
        batch = {"tokens": torch.from_numpy(np.asarray(prompts, np.int32)).to(dev)}
        for k, v in (extras or {}).items():
            batch[k] = torch.from_numpy(np.array(v)).to(dev)
        # the encoder's output, once, for every decode step
        step_extra = (() if cfg.encoder is None
                      else (tf.encode(cfg, self.params, batch["enc_frames"]),))
        logits, caches = self._prefill(self.params, batch)
        caches = self._relayout(caches, S0, total)

        # emit-then-feed: out[:, t] is the prediction of position S0 + t,
        # starting with the prefill's own next-token prediction
        gen = None
        if scfg.temperature > 0:
            gen = torch.Generator(device=dev).manual_seed(scfg.seed)
        lg = logits[:, -1]
        out: List[torch.Tensor] = []
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        for t in range(scfg.max_new_tokens):
            if gen is not None:
                u = torch.rand(lg.shape, generator=gen, device=dev)
                gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
                tok = torch.argmax(lg / scfg.temperature + gumbel, dim=-1)
            else:
                tok = torch.argmax(lg, dim=-1)
            tok = tok.to(torch.int32)[:, None]
            out.append(torch.where(done, scfg.eos_id, tok[:, 0]))
            if scfg.eos_id >= 0:
                done |= out[-1] == scfg.eos_id
                if bool(done.all()):
                    break
            if t == scfg.max_new_tokens - 1:
                break
            logits, caches = self._step(self.params, tok, S0 + t, caches,
                                        *step_extra)
            lg = logits[:, -1]
        return torch.stack(out, dim=1).cpu().numpy()
