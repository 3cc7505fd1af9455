"""CAQR-Muon: momentum orthogonalized by the paper's TSQR (port of
``src/repro/optim/caqr_muon.py``).

The momentum of each 2-D weight is replaced by the thin-QR Q of the
port's sequential TSQR chain (``core.tsqr.tsqr_orthonormalize``; on a
CUDA tensor its leaf QR and chain steps are K1 at b = the slice's short
side, which above 128 columns runs K1's blocked route,
``kernels/wide.py``). Embeddings, the LM head and non-2-D parameters take
Adam-style scaling; stacked groups ``(G, m, n)`` are orthogonalized per
slice. Paths are ``repro_torch.tree`` path strings, the JAX package's
letter for letter, so both packages route the same leaves.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree
from repro_torch.core.tsqr import tsqr_orthonormalize
from repro_torch.optim.adamw import Optimizer

_EXCLUDE = ("embed", "lm_head", "enc_pos")


class MuonState(NamedTuple):
    step: torch.Tensor
    mom: Any   # f32 momentum (all params)
    nu: Any    # adam second moment (used on the non-muon subset)


def _path_str(path) -> str:
    """A path string as is, or a sequence of keys joined by ``/``."""
    return path if isinstance(path, str) else "/".join(str(k) for k in path)


def _is_muon(path, p: torch.Tensor) -> bool:
    if any(e in _path_str(path) for e in _EXCLUDE):
        return False
    return p.dim() >= 2 and p.shape[-1] > 1 and p.shape[-2] > 1


def _orth2d(M: torch.Tensor, tile_rows: int = 512) -> torch.Tensor:
    m, n = M.shape
    tall = m >= n
    A = M if tall else M.T
    rows, cols = A.shape
    tile = rows
    for cand in (tile_rows, 256, 128, 64):
        if rows % cand == 0 and cand >= cols:
            tile = cand
            break
    Q, _ = tsqr_orthonormalize(A.contiguous(), tile)
    return Q if tall else Q.T


def _orth(M: torch.Tensor) -> torch.Tensor:
    if M.dim() == 2:
        return _orth2d(M)
    flat = M.reshape((-1,) + M.shape[-2:])
    return torch.stack([_orth2d(s) for s in flat]).reshape(M.shape)


def _orth_default(path, m: torch.Tensor) -> torch.Tensor:
    return _orth(m)


def muon_moments(grads, state: MuonState, params,
                 *, b1: float = 0.95, adam_b2: float = 0.95):
    """The momentum / second-moment update, shared by ``caqr_muon`` and
    the FT runtime's grad phase. Returns ``(mom, nu)``."""

    def upd_mom(path, g, m, p):
        if _is_muon(path, p):
            return b1 * m + g.float()
        return b1 * m + (1 - b1) * g.float()

    def upd_nu(path, g, v, p):
        if _is_muon(path, p):
            return v
        return adam_b2 * v + (1 - adam_b2) * torch.square(g.float())

    return (tree.map_with_path(upd_mom, grads, state.mom, params),
            tree.map_with_path(upd_nu, grads, state.nu, params))


def muon_deltas(params, mom, nu, lr, t,
                *, b1: float = 0.95, adam_b2: float = 0.95,
                eps: float = 1e-8, weight_decay: float = 0.0,
                adam_scale: float = 0.3, orth=_orth_default):
    """The parameter-delta phase: Muon leaves get ``orth(path, mom)``,
    everything else the Adam-style scaling. ``t`` is the float step count
    after the increment; the FT runtime passes an ``orth`` that returns
    the Q factors of its sweeps for the routed leaves."""

    def delta(path, p, m, v):
        if _is_muon(path, p):
            O = orth(path, m)
            scale = torch.sqrt(torch.tensor(
                max(1.0, p.shape[-2] / p.shape[-1]), dtype=torch.float32))
            d = O * scale + weight_decay * p.float()
            return (-lr * d).to(p.dtype)
        m_hat = m / (1 - b1 ** t)
        v_hat = v / (1 - adam_b2 ** t)
        d = m_hat / (torch.sqrt(v_hat) + eps)
        return (-lr * adam_scale * d).to(p.dtype)

    return tree.map_with_path(delta, params, mom, nu)


def caqr_muon(
    b1: float = 0.95,
    adam_b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    adam_scale: float = 0.3,
) -> Optimizer:
    def init(params):
        mom = tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        nu = tree.map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return MuonState(step=torch.zeros((), dtype=torch.int32), mom=mom, nu=nu)

    def update(grads, state: MuonState, params, lr):
        step = state.step + 1
        t = step.float()
        mom, nu = muon_moments(grads, state, params, b1=b1, adam_b2=adam_b2)
        updates = muon_deltas(
            params, mom, nu, lr, t, b1=b1, adam_b2=adam_b2, eps=eps,
            weight_decay=weight_decay, adam_scale=adam_scale)
        return updates, MuonState(step=step, mom=mom, nu=nu)

    return Optimizer(init=init, update=update, recipe=(caqr_muon, dict(
        b1=b1, adam_b2=adam_b2, eps=eps, weight_decay=weight_decay,
        adam_scale=adam_scale)))
