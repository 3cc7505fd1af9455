"""AdamW (port of ``src/repro/optim/adamw.py``): functional, over trees
of tensors (``repro_torch.tree``). The step count is a 0-dim int32 host
tensor, the moments are float32 on the parameters' device."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


class Optimizer(NamedTuple):
    init: Any
    update: Any
    # (factory, keyword arguments) that rebuild it in another process: the
    # rank processes of a pod step rebuild their optimizer from it
    recipe: Any = None


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        zeros = tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamWState(step=torch.zeros((), dtype=torch.int32), mu=zeros,
                          nu=tree.map(torch.clone, zeros))

    def update(grads, state: AdamWState, params, lr):
        step = state.step + 1
        t = step.float()
        mu = tree.map(lambda g, m: b1 * m + (1 - b1) * g.float(), grads, state.mu)
        nu = tree.map(lambda g, v: b2 * v + (1 - b2) * torch.square(g.float()),
                      grads, state.nu)

        def delta(m, v, p):
            m_hat = m / (1 - b1 ** t)
            v_hat = v / (1 - b2 ** t)
            d = m_hat / (torch.sqrt(v_hat) + eps) + weight_decay * p.float()
            return (-lr * d).to(p.dtype)

        updates = tree.map(delta, mu, nu, params)
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update, recipe=(adamw, dict(
        b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)))


def apply_updates(params, updates):
    return tree.map(lambda p, u: p + u.to(p.dtype), params, updates)
