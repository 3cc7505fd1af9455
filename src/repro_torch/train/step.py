"""Train-step builders (port of ``src/repro/train/step.py``).

``make_loss_and_grads`` — ``(params, batch) -> (loss, grads)`` with the
optional microbatch accumulation, shared by the monolithic step and the
FT runtime's grad phase so both run one program; ``make_train_step`` —
loss, gradients and the optimizer update. ``make_pod_train_step`` (the
cross-pod reduction) waits for the training half of the multi-process
path (``ROADMAP.md`` queue 1, item 4c) and raises until then.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
import repro_torch.optim.adamw as adamw_mod


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor   # 0-dim int32, on the host


def _value_and_grad(loss_fn: Callable, params, batch):
    paths = tree.flatten_with_path(params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in paths]
    p = tree.unflatten_like(params, {path: x for (path, _), x in zip(paths, leaves)})
    with torch.enable_grad():
        loss, _ = loss_fn(p, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss.detach(), tree.unflatten_like(
        params, {path: g for (path, _), g in zip(paths, grads)})


def make_loss_and_grads(cfg: ModelConfig, grad_accum: int = 1):
    """The gradient computation of ``make_train_step`` as its own builder:
    ``(params, batch) -> (loss, grads)``; with ``grad_accum > 1`` the
    batch is split on its leading axis and the float32 sums divided."""
    loss_fn = api.make_forward_loss(cfg)

    def fn(params, batch):
        if grad_accum == 1:
            return _value_and_grad(loss_fn, params, batch)
        B = batch["tokens"].shape[0]
        assert B % grad_accum == 0
        mb = B // grad_accum
        loss = torch.zeros((), dtype=torch.float32,
                           device=batch["tokens"].device)
        grads = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        for i in range(grad_accum):
            b = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            li, gi = _value_and_grad(loss_fn, params, b)
            loss = loss + li
            grads = tree.map(torch.add, grads, gi)
        return loss / grad_accum, tree.map(lambda g: g / grad_accum, grads)

    return fn


def grad_norm(grads) -> torch.Tensor:
    """Global L2 norm over a gradient tree (float32 accumulate)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree.leaves(grads)))


def make_train_step(
    cfg: ModelConfig,
    optimizer,
    lr_fn: Callable,
    grad_accum: int = 1,
):
    loss_and_grads = make_loss_and_grads(cfg, grad_accum)

    def step(state: TrainState, batch):
        loss, grads = loss_and_grads(state.params, batch)
        with torch.no_grad():
            lr = lr_fn(state.step)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params, lr)
            params = adamw_mod.apply_updates(state.params, updates)
            return TrainState(params, opt_state, state.step + 1), {
                "loss": loss, "lr": lr, "gnorm": grad_norm(grads)}

    return step


def make_pod_train_step(*args, **kwargs):
    raise NotImplementedError(
        "make_pod_train_step reduces over a named 'pod' axis: it waits for "
        "the training half of the multi-process path (ROADMAP.md queue 1, "
        "item 4c)")
