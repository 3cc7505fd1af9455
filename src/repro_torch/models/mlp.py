"""Channel mixers: gated / plain MLPs (port of
``src/repro/models/mlp.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import act_fn


class MLPParams(NamedTuple):
    w_in: torch.Tensor    # (D, F) — or gate proj for gated activations
    w_gate: torch.Tensor  # (D, F) — (1, 1) when unused
    w_out: torch.Tensor   # (F, D)


def mlp_forward(p: MLPParams, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation in ("swiglu", "geglu"):
        gate = x @ p.w_gate
        up = x @ p.w_in
        act = F.silu(gate) if activation == "swiglu" else F.gelu(gate, approximate="tanh")
        inner = act * up
    else:
        inner = act_fn(activation)(x @ p.w_in)
    return inner @ p.w_out
