"""Train-step builders (port of ``src/repro/train/step.py``).

``make_loss_and_grads`` — ``(params, batch) -> (loss, grads)`` with the
optional microbatch accumulation, shared by the monolithic step and the
FT runtime's grad phase so both run one program; ``make_train_step`` —
loss, gradients and the optimizer update; ``make_pod_train_step`` — the
multi-pod step: the state replicated over the mesh's "pod" axis, the
batch's leading dimension split over it, and the gradients and the loss
averaged across pods explicitly (``compat.pmean``), or the gradients
through PowerSGD-QR (rank-r TSQR, r (m + n) values a matrix on the wire
instead of m n): the paper's primitive on the slowest links.

A pod is an element of the mesh's "pod" axis, run by
``compat.run_manual`` in a rank process of the mesh's group (or a thread
of a ``threads`` mesh, the one-process counterpart, bit for bit) as a
resident body: the pods keep their state between calls. A call given the
state the step returned last runs on the pods' own copies; any other
state is shipped to every pod (through one staging buffer on ranks). The
error-feedback buffers differ between pods; as the reference returns them
under a replicated out-spec (pod 0's copy when fetched, each pod going on
with its own), the step returns pod 0's state and each pod keeps its own.
"""
from __future__ import annotations

import functools
import uuid
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from repro_torch import tree
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import compat
from repro_torch.models import api
import repro_torch.optim.adamw as adamw_mod
from repro_torch.optim import powersgd


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


class PodTrainState(NamedTuple):
    params: Any
    opt_state: Any
    psgd: Any
    step: torch.Tensor


def pod_body(cfg: ModelConfig, optimizer, lr_fn: Callable,
             compression_rank: int = 0) -> Callable:
    """One pod's step ``(state, batch) -> (state, metrics)``, reducing over
    the bound "pod" axis: the reference's ``per_pod``."""
    loss_fn = api.make_forward_loss(cfg)
    compress = compression_rank > 0

    def per_pod(state: PodTrainState, batch):
        loss, grads = _value_and_grad(loss_fn, state.params, batch)
        with torch.no_grad():
            if compress:
                grads, new_psgd = powersgd.compress_tree(
                    grads, state.psgd, "pod", rank=compression_rank)
            else:
                grads = tree.map(lambda g: compat.pmean(g, "pod"), grads)
                new_psgd = state.psgd
            loss = compat.pmean(loss, "pod")
            lr = lr_fn(state.step)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params, lr)
            params = adamw_mod.apply_updates(state.params, updates)
            return PodTrainState(params, opt_state, new_psgd,
                                 state.step + 1), {"loss": loss, "lr": lr}

    return per_pod


def _rebuilt(recipe) -> Callable:
    cfg, (opt_factory, opt_kw), (lr_factory, lr_kw), rank = recipe
    return pod_body(cfg, opt_factory(**opt_kw), lr_factory(**lr_kw), rank)


def _pod_element(kept: dict, batch, build: Callable, shipped, modes: tuple):
    """One pod's step, resident in its element of the mesh: ``per_pod``
    (built once) on the shipped state, or on the one it kept, with the
    caller's deterministic flags; the new state kept. Pod 0 answers with
    its state, every pod with the metrics."""
    if "per_pod" not in kept:
        kept["per_pod"] = build()
    if shipped is not None:
        kept["state"] = shipped
    if kept.get("state") is None:
        raise RuntimeError("the pod has no state: ship one")
    torch.use_deterministic_algorithms(modes[0], warn_only=modes[1])
    torch.utils.deterministic.fill_uninitialized_memory = modes[2]
    state, metrics = kept["per_pod"](kept["state"], batch)
    kept["state"] = state
    return (state if compat.axis("pod").rank == 0 else None), metrics


def _kept_state(kept: dict):
    return kept["state"]


class PodTrainStep:
    """The step ``make_pod_train_step`` returns: ``step(state, batch) ->
    (state, metrics)`` over the mesh's "pod" axis, each pod a resident
    body of ``compat.run_manual`` (see the module docstring).
    ``rank_states()`` gives every pod's own state, ``reports`` the ranks'
    ``RankReport`` of the last call (seconds, K1-K6 launches, the pod
    axis's collectives and bytes, peak device memory). Close it to drop
    the pods' states (the mesh's ranks stay)."""

    def __init__(self, cfg: ModelConfig, optimizer, lr_fn: Callable, mesh,
                 compression_rank: int = 0):
        if "pod" not in mesh.axis_names:
            raise ValueError(f"{mesh} has no 'pod' axis")
        self.mesh = mesh
        self.n = mesh.shape["pod"]
        self.compression_rank = compression_rank
        if mesh.threads:
            self._build = functools.partial(pod_body, cfg, optimizer, lr_fn,
                                            compression_rank)
        else:
            for what, obj in (("optimizer", optimizer), ("lr_fn", lr_fn)):
                if getattr(obj, "recipe", None) is None:
                    raise ValueError(
                        f"the ranks rebuild the {what} from its recipe: "
                        "make it with a factory of repro_torch.optim")
            self._build = functools.partial(_rebuilt, (
                cfg, optimizer.recipe, lr_fn.recipe, compression_rank))
        self.token = uuid.uuid4().hex
        self._last: Optional[PodTrainState] = None
        self._open = False
        self.reports: list = []

    def _batches(self, batch) -> list:
        """The batch's leading dimension split over the pods (the
        reference's in-spec P("pod"), which refuses a remainder)."""
        for x in tree.leaves(batch):
            if x.shape[0] % self.n:
                raise ValueError(f"a batch of {x.shape[0]} rows does not "
                                 f"split over {self.n} pods")
        return [tree.map(lambda x: x.narrow(0, i * (x.shape[0] // self.n),
                                            x.shape[0] // self.n), batch)
                for i in range(self.n)]

    def __call__(self, state: PodTrainState, batch):
        shipped = None if (self._last is not None
                           and state is self._last) else state
        self._last = None
        modes = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled(),
                 torch.utils.deterministic.fill_uninitialized_memory)
        each = [(b, self._build, shipped, modes) for b in self._batches(batch)]
        self._open = True
        outs = compat.run_manual(_pod_element, self.mesh, each, {"pod"},
                                 session=self.token)
        if not self.mesh.threads:
            self.reports = self.mesh.group.last_reports
        out, metrics = outs[0]
        self._last = out
        return out, metrics

    @property
    def peak_bytes(self) -> List[int]:
        """Each rank's peak device memory in the last call."""
        return [r.peak_bytes for r in self.reports]

    def rank_states(self) -> List[PodTrainState]:
        """Every pod's own current state, in pod order (copies, on ranks)."""
        return compat.run_manual(_kept_state, self.mesh, [()] * self.n,
                                 {"pod"}, session=self.token)

    def close(self) -> None:
        if self._open:
            compat.drop_session(self.mesh, self.token, {"pod"})
        self._open = False
        self._last = None


def make_pod_train_step(cfg: ModelConfig, optimizer, lr_fn: Callable, mesh,
                        *, compression_rank: int = 0) -> PodTrainStep:
    """The reference's ``make_pod_train_step``: per-pod gradients reduced
    across the mesh's "pod" axis by ``pmean`` or, with ``compression_rank``
    > 0, by PowerSGD-QR; parameters replicated across pods, the other axes
    automatic (replicated inside each pod). On ranks, ``optimizer`` and
    ``lr_fn`` must come from the port's factories (``adamw``,
    ``caqr_muon``; ``schedule.constant``, ``warmup_cosine``), whose
    recipes rebuild them there."""
    return PodTrainStep(cfg, optimizer, lr_fn, mesh, compression_rank)
