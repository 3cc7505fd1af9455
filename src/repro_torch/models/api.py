"""Model-facing API (port of ``src/repro/models/api.py``):
``make_forward_loss``. The serve and prefill builders wait for the LLM
engine's port (``ROADMAP.md`` queue 1, item 8)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def make_forward_loss(cfg: ModelConfig):
    def fl(params, batch):
        return tf.loss_fn(cfg, params, batch)

    return fl
