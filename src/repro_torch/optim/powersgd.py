"""PowerSGD-QR: low-rank gradient compression whose orthonormalization is
the paper's TSQR (port of ``src/repro/optim/powersgd.py``).

For a gradient matrix G (m, n) and a sketch Omega (n, r):
P = (G + E) Omega, Q = TSQR-orth(P), R = (G + E)^T Q, G_hat = Q R^T and
the error feedback E <- (G + E) - G_hat; the next sketch is R (power
iteration warm start). The three phases (``psgd_project``,
``psgd_rfactor``, ``psgd_complete``) are the FT runtime's split form.

Over a named axis (a manual axis of a body mapped over a mesh,
``repro_torch.dist.compat``, e.g. "pod"), P and R are averaged across its
elements with ``compat.pmean`` (the elements' values summed in element
order), so r(m + n) values a matrix cross the axis instead of m n; the
TSQR of the reduced P runs on every element, redundantly, as in the
reference. ``axis_name=None`` runs the compression locally (the rank-r
filter).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.dist import compat
from repro_torch.core.tsqr import tsqr_orthonormalize


class PowerSGDState(NamedTuple):
    error: Any    # error-feedback buffers (same structure as the 2-D subset)
    sketch: Any   # warm-start sketches ((n, r) per compressible leaf)


def _tile_for(rows: int, cols: int) -> int:
    for cand in (512, 256, 128, 64):
        if rows % cand == 0 and cand >= cols:
            return cand
    return rows


def psgd_project(G: torch.Tensor, omega: torch.Tensor,
                 error: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1: the error-compensated gradient and its sketch projection
    ``(Gc, Gc @ omega)``."""
    Gc = G.float() + error
    return Gc, Gc @ omega.float()


def psgd_rfactor(Gc: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Phase 2: this lane's R contribution ``Gc^T @ Q``."""
    return Gc.T @ Q


def psgd_complete(Gc: torch.Tensor, Q: torch.Tensor, R: torch.Tensor,
                  out_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 3: reconstruction and error feedback, ``(G_hat, new_error)``."""
    G_hat = Q @ R.T
    return G_hat.to(out_dtype), Gc - G_hat


def compress_reduce(
    G: torch.Tensor,
    omega: torch.Tensor,
    error: torch.Tensor,
    axis_name: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (G_hat averaged over the axis, new error, next sketch);
    with ``axis_name=None`` the compression runs locally."""
    m, n = G.shape
    r = omega.shape[1]
    Gc, P = psgd_project(G, omega, error)
    if axis_name is not None:
        P = compat.pmean(P, axis_name)
    Q, _ = tsqr_orthonormalize(P, _tile_for(m, r))
    R = psgd_rfactor(Gc, Q)
    if axis_name is not None:
        R = compat.pmean(R, axis_name)
    G_hat, new_error = psgd_complete(Gc, Q, R, G.dtype)
    return G_hat, new_error, R


def _compressible(p: torch.Tensor, min_size: int) -> bool:
    return p.dim() == 2 and p.numel() >= min_size


def init_state(gen: torch.Generator, params, rank: int = 8,
               min_size: int = 4096) -> PowerSGDState:
    """Zero error buffers and random initial sketches (drawn from ``gen``
    on its device, in the leaves' path order) per compressible leaf."""
    dev = gen.device
    empty = lambda: torch.zeros((0,), dtype=torch.float32, device=dev)  # noqa: E731
    sketches = {}
    for path, p in tree.flatten_with_path(params):
        if _compressible(p, min_size):
            sketches[path] = torch.randn(
                (p.shape[1], rank), generator=gen, dtype=torch.float32,
                device=dev) / math.sqrt(rank)
        else:
            sketches[path] = empty()
    error = tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device)
                     if _compressible(p, min_size) else empty(), params)
    return PowerSGDState(error=error,
                         sketch=tree.unflatten_like(params, sketches))


def compress_tree(grads, state: PowerSGDState, axis_name: Optional[str],
                  rank: int = 8, min_size: int = 4096):
    """Compress-reduce every eligible leaf and average the rest over the
    axis (with ``axis_name=None`` they pass through); returns (grads, new
    state)."""
    out = {}
    flat_om = dict(tree.flatten_with_path(state.sketch))
    flat_err = dict(tree.flatten_with_path(state.error))
    for path, g in tree.flatten_with_path(grads):
        om, e = flat_om[path], flat_err[path]
        if _compressible(g, min_size):
            out[path] = compress_reduce(g, om, e, axis_name)
        else:
            out[path] = (g if axis_name is None
                         else compat.pmean(g, axis_name), e, om)
    pick = lambda i: tree.unflatten_like(  # noqa: E731
        grads, {k: v[i] for k, v in out.items()})
    return pick(0), PowerSGDState(error=pick(1), sketch=pick(2))
