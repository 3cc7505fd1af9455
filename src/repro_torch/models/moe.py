"""Mixture-of-Experts channel mixer with sort-based capacity dispatch (port
of ``src/repro/models/moe.py``).

Written as the reference writes it:

  1. router logits in float32 -> top-k experts and their normalized
     weights per token, and the switch-style load-balance aux loss;
  2. dispatch: the (token, k) assignments sorted by expert id (a stable
     sort); each takes the slot ``position-in-expert`` from the sorted
     order, and an assignment past the expert's capacity
     ``C = max(int(capacity_factor * N * top_k / E), 8)`` is dropped (its
     combine weight adds nothing);
  3. expert compute: the gathered activations fill an (E, C, D) buffer that
     runs through the batched gated MLP (``torch.bmm``; the JAX package's
     expert products are einsums outside any Pallas kernel too);
  4. combine: the results scatter back to (N, D) weighted by the router.

Routing is exactly the reference's on the same inputs: ``lax.top_k``
breaks ties toward the lower expert index, so the top-k is a stable sort
of ``-probs`` (keys ``(-prob, index)``), not ``torch.topk``, whose tie order
is not promised; ``argsort`` is stable and ``searchsorted`` takes the left
side. The scatter-adds are ``index_add_`` and the gathers
``index_select``/``gather``, whose CUDA versions (and backward passes) are
deterministic under ``torch.use_deterministic_algorithms(True)``, so a run
repeats bit for bit on the card. The reference's sharding annotations have
no counterpart on one card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class MoEParams(NamedTuple):
    w_router: torch.Tensor  # (D, E)
    w_gate: torch.Tensor    # (E, D, F)
    w_in: torch.Tensor      # (E, D, F)
    w_out: torch.Tensor     # (E, F, D)


class Routing(NamedTuple):
    """The dispatch of one group's (token, k) assignments, in sorted
    order: expert id, token, router weight, slot in the expert's buffer,
    and whether the slot is inside the capacity ``C``."""

    expert: torch.Tensor   # (N*K,) int64
    token: torch.Tensor    # (N*K,) int64
    gate: torch.Tensor     # (N*K,) float32
    pos: torch.Tensor      # (N*K,) int64
    keep: torch.Tensor     # (N*K,) bool
    capacity: int


def capacity(n_tokens: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    return max(int(capacity_factor * n_tokens * top_k / n_experts), 8)


def route(probs: torch.Tensor, top_k: int, capacity_factor: float
          ) -> Tuple[Routing, torch.Tensor]:
    """The reference's top-k, normalized gates and sort-based dispatch of
    router probabilities ``probs (N, E)``. Returns ``(routing,
    expert_ids (N, K))``."""
    N, E = probs.shape
    # lax.top_k: largest first, ties to the lower index
    expert_ids = torch.sort(-probs.detach(), dim=-1, stable=True).indices[:, :top_k]
    gate_vals = torch.gather(probs, -1, expert_ids)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    C = capacity(N, top_k, E, capacity_factor)
    flat_expert = expert_ids.reshape(-1)
    flat_token = torch.repeat_interleave(
        torch.arange(N, device=probs.device), top_k)
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    seg_start = torch.searchsorted(
        sorted_expert, torch.arange(E, device=probs.device), side="left")
    pos = torch.arange(N * top_k, device=probs.device) - seg_start[sorted_expert]
    routing = Routing(expert=sorted_expert, token=flat_token[order],
                      gate=gate_vals.reshape(-1)[order], pos=pos,
                      keep=pos < C, capacity=C)
    return routing, expert_ids


def moe_forward(
    p: MoEParams,
    x: torch.Tensor,          # (B, S, D)
    *,
    top_k: int,
    capacity_factor: float,
    activation: str = "swiglu",
    shards: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(out (B, S, D), aux_loss)``. ``shards > 1`` dispatches per
    token-shard group (the reference's vmap over groups, each with its own
    capacity; the aux loss is the groups' mean). ``shards`` must divide
    B*S."""
    B, S, D = x.shape
    N = B * S
    if shards > 1:
        assert N % shards == 0, (N, shards)
        groups = [_moe_group(p, xs, top_k=top_k, capacity_factor=capacity_factor,
                             activation=activation)
                  for xs in x.reshape(shards, N // shards, D)]
        out = torch.stack([o for o, _ in groups]).reshape(B, S, D)
        return out, torch.mean(torch.stack([a for _, a in groups]))
    out, aux = _moe_group(p, x.reshape(N, D), top_k=top_k,
                          capacity_factor=capacity_factor, activation=activation)
    return out.reshape(B, S, D), aux


def router_probs(p: MoEParams, xf: torch.Tensor) -> torch.Tensor:
    """Softmax of the float32 router logits of tokens ``xf (N, D)``."""
    logits = xf.float() @ p.w_router.float()
    return torch.softmax(logits, dim=-1)


def _moe_group(
    p: MoEParams,
    xf: torch.Tensor,         # (N, D) one dispatch group's tokens
    *,
    top_k: int,
    capacity_factor: float,
    activation: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    N, D = xf.shape
    E = p.w_router.shape[1]

    # --- router (f32 for numerics) -----------------------------------------
    probs = router_probs(p, xf)
    r, expert_ids = route(probs, top_k, capacity_factor)

    # switch-style load-balance aux loss
    density = torch.mean(F.one_hot(expert_ids[:, 0], E).float(), dim=0)
    density_proxy = torch.mean(probs, dim=0)
    aux_loss = torch.sum(density * density_proxy) * (E * E) / E

    # --- dispatch into the (E, C, D) buffer ---------------------------------
    C = r.capacity
    keep = r.keep[:, None]
    # slot e*C + pos of a kept assignment; a dropped one adds zeros at (0, 0)
    slot = torch.where(r.keep, r.expert * C + r.pos, 0)
    src = torch.where(keep, xf.index_select(0, r.token), 0)
    buf = xf.new_zeros((E * C, D)).index_add(0, slot, src).reshape(E, C, D)

    # --- expert MLPs (batched products) -------------------------------------
    gate = torch.bmm(buf, p.w_gate)
    up = torch.bmm(buf, p.w_in)
    if activation == "swiglu":
        inner = F.silu(gate) * up
    elif activation == "geglu":
        # jax.nn.gelu's default is the tanh form
        inner = F.gelu(gate, approximate="tanh") * up
    else:
        inner = torch.square(F.relu(gate))
    out_buf = torch.bmm(inner, p.w_out).reshape(E * C, D)

    # --- combine --------------------------------------------------------------
    picked = torch.where(keep, out_buf.index_select(0, slot), 0)
    contrib = picked * r.gate[:, None].to(picked.dtype)
    out = xf.new_zeros((N, D)).index_add(0, r.token, contrib.to(xf.dtype))
    return out, aux_loss
