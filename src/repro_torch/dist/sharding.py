"""Logical-axis sharding annotations (port of
``src/repro/dist/sharding.py``).

Model code of the reference annotates activations with *logical* axis
names (``ax(x, "batch", None, "heads", None)``) and a rule table maps each
to a mesh axis, a tuple of mesh axes, or None (replicated). The port keeps
the tables and ``ax``: the identity outside a ``use_rules`` context, and
inside one a check that one name is given per dimension. On one card a
constraint has no counterpart, so ``ax`` returns its input either way; the
port's models do not call it (``models/common.py``).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, Optional

import torch

_STATE = threading.local()


def current_rules() -> Optional[Dict[str, Any]]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def use_rules(rules: Dict[str, Any]) -> Iterator[None]:
    """Activate a logical-axis -> mesh-axis rule table for the enclosed
    code (this thread)."""
    prev = current_rules()
    _STATE.rules = dict(rules)
    try:
        yield
    finally:
        _STATE.rules = prev


def ax(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """``x`` annotated by logical axis names (one per dimension): the
    identity, which inside a rule table checks the rank."""
    if current_rules() is None:
        return x
    assert len(logical_axes) == x.dim(), (logical_axes, tuple(x.shape))
    return x


def single_pod_rules() -> Dict[str, Any]:
    """16x16 (data x model) pod: batch over data, width dims over model."""
    return {
        "batch": "data",
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "experts": "model",
        "ssm_heads": "model",
        "lru": "model",
        "seq_shard": None,
        "kv_seq_shard": None,
    }


def multi_pod_rules() -> Dict[str, Any]:
    """2x16x16 (pod x data x model): batch spans both pod and data."""
    rules = single_pod_rules()
    rules["batch"] = ("pod", "data")
    return rules


def long_decode_overrides(rules: Dict[str, Any]) -> Dict[str, Any]:
    """long_500k decode: the cache's sequence dim shards over every axis and
    the (small) decode batch stays replicated, the inverse of training."""
    rules = dict(rules)
    rules["batch"] = None
    rules["kv_seq_shard"] = ("data", "model")
    return rules
