"""Model-facing API (port of ``src/repro/models/api.py``): the step
functions ``make_forward_loss``, ``make_prefill`` and ``make_serve_step``.
The input and parameter specs of the dry-run (``decode_input_specs``,
``param_specs``) wait for its port (``ROADMAP.md`` queue 1, item 9)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def make_forward_loss(cfg: ModelConfig):
    def fl(params, batch):
        return tf.loss_fn(cfg, params, batch)

    return fl


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, token, pos, caches, enc_out=None):
        return tf.decode_step(cfg, params, caches, token, pos, enc_out=enc_out)

    return serve_step


def make_prefill(cfg: ModelConfig):
    """``prefill(params, batch) -> (logits (B,1,V), caches)``: the logits
    of the last position only (a (B, S, V) float32 tensor at a published
    vocabulary would be gigabytes)."""
    def prefill(params, batch):
        hidden, caches, _ = tf.forward(
            cfg, params, batch["tokens"],
            patch_embeds=batch.get("patch_embeds"),
            enc_frames=batch.get("enc_frames"),
            mode="prefill",
        )
        logits = tf.logits_fn(cfg, params, hidden[:, -1:])
        return logits, caches

    return prefill
