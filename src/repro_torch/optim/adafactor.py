"""Adafactor (port of ``src/repro/optim/adafactor.py``): factored second
moments, no first moment.

The memory-frugal optimizer of the dry run's largest cells (kimi-k2,
nemotron-4-340b, mixtral-8x22b): an (m, n) weight keeps m + n float32
second moments instead of AdamW's 2 m n. A leaf is factored when it has
at least two dimensions and both of its last two exceed 1; any other leaf
keeps a full second moment in ``vr`` and ``zeros((0,))`` in ``vc``. The
update runs in float32, is clipped by its RMS and is cast to the
parameter's dtype. The step count is a 0-dim int32 host tensor, the
moments float32 on the parameters' device (the meta device too, for the
dry run's specs).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.optim.adamw import Optimizer


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any   # row second moments (or the full v of a leaf not factored)
    vc: Any   # column second moments (zeros((0,)) for a leaf not factored)


def factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def adafactor(
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
) -> Optimizer:
    def init(params):
        def zeros(p, shape):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def vr0(p):
            return zeros(p, p.shape[:-1] if factored(p) else p.shape)

        def vc0(p):
            return zeros(p, p.shape[:-2] + p.shape[-1:] if factored(p) else (0,))

        return AdafactorState(step=torch.zeros((), dtype=torch.int32),
                              vr=tree.map(vr0, params), vc=tree.map(vc0, params))

    def update(grads, state: AdafactorState, params, lr):
        step = state.step + 1
        beta = 1.0 - step.float() ** (-decay)

        def upd(g, vr, vc, p):
            g = g.float()
            g2 = g * g + eps
            if factored(p):
                vr_new = beta * vr + (1 - beta) * torch.mean(g2, dim=-1)
                vc_new = beta * vc + (1 - beta) * torch.mean(g2, dim=-2)
                denom = torch.sqrt(
                    vr_new[..., None] * vc_new[..., None, :]
                    / torch.mean(vr_new, dim=-1, keepdim=True)[..., None])
            else:
                vr_new = beta * vr + (1 - beta) * g2
                vc_new = vc
                denom = torch.sqrt(vr_new)
            u = g / torch.clamp(denom, min=eps)
            # update clipping (RMS)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            return (-lr * u).to(p.dtype), vr_new, vc_new

        # one pass per leaf; the three trees are read off its results
        out = {path: upd(g, vr, vc, p) for (path, g), vr, vc, p in zip(
            tree.flatten_with_path(grads), tree.leaves(state.vr),
            tree.leaves(state.vc), tree.leaves(params))}
        part = lambda i: tree.unflatten_like(  # noqa: E731
            params, {path: r[i] for path, r in out.items()})
        return part(0), AdafactorState(step=step, vr=part(1), vc=part(2))

    return Optimizer(init=init, update=update, recipe=(adafactor, dict(
        decay=decay, eps=eps, clip_threshold=clip_threshold)))
