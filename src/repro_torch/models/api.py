"""Model-facing API (port of ``src/repro/models/api.py``): the input and
parameter specs of every (arch x shape) cell and the step functions
``make_forward_loss``, ``make_prefill`` and ``make_serve_step``.

The specs are tensors on the meta device (shapes, dtypes and paths, no
storage), where the reference has ``ShapeDtypeStruct`` stand-ins; the dry
run (``launch/dryrun.py``) runs the steps on them. Modality frontends are
stubs, as in the reference: whisper takes precomputed frame embeddings,
pixtral precomputed patch embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k skipped: arch has full-attention layers"
    return True, ""


def train_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs = {
        "tokens": _spec((B, S), torch.int32),
        "labels": _spec((B, S), torch.int32),
    }
    if cfg.vlm is not None:
        specs["patch_embeds"] = _spec((B, cfg.vlm.n_patches, cfg.d_model),
                                      cfg.torch_dtype)
    if cfg.encoder is not None:
        specs["enc_frames"] = _spec((B, cfg.encoder.n_frames, cfg.d_model),
                                    cfg.torch_dtype)
    return specs


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``token``, ``pos`` (a 0-dim int32 spec; the port's decode step takes
    the position as a Python int), the caches of ``init_caches`` and, for an
    encoder, ``enc_out``."""
    B, S = shape.global_batch, shape.seq_len
    specs = {
        "token": _spec((B, 1), torch.int32),
        "pos": _spec((), torch.int32),
        "caches": tf.init_caches(cfg, B, S, device="meta"),
    }
    if cfg.encoder is not None:
        specs["enc_out"] = _spec((B, cfg.encoder.n_frames, cfg.d_model),
                                 cfg.torch_dtype)
    return specs


def param_specs(cfg: ModelConfig) -> Any:
    """The parameter tree on the meta device (``transformer.param_template``)."""
    return tf.param_template(cfg)


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
