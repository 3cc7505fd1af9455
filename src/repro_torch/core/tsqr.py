"""TSQR: tall-skinny QR via reduction trees (port of
``src/repro/core/tsqr.py``).

* ``baseline_tsqr`` — the classical binary reduction tree: only lane 0
  ends with R.
* ``ft_tsqr`` — the paper's fault-tolerant butterfly: the pair exchanges
  R and BOTH lanes compute the identical stacked QR (one K3 launch over
  all lanes), so every lane ends with the same final R and any lane's
  ladder of combine factors is reconstructible from its XOR buddy.

Stacking convention: within a pair, the lane whose index bit at the
current level matches the target's bit is the TOP block (its Y is I).
Plus the sequential single-device chain ``local_tsqr``, and the
``*_spmd`` wrappers, which run ``ft_tsqr`` and ``dist_orthonormalize``
in one rank of a process group (``AxisComm``).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.comm import axis_comm, lane_block
from repro_torch.core.householder import (
    StackedQR,
    apply_q,
    householder_qr,
    stacked_apply_q,
    stacked_qr,
)


# ---------------------------------------------------------------------------
# Local (single-device) sequential TSQR chain.
# ---------------------------------------------------------------------------


class ChainFactors(NamedTuple):
    """Factors of a sequential TSQR chain over row tiles: the WY of tile 0
    and of each stacked [R_prev; tile_t] step, stacked on a leading axis."""

    leaf_Y: torch.Tensor
    leaf_T: torch.Tensor
    step_Y: torch.Tensor  # (T-1, b + tile_rows, b)
    step_T: torch.Tensor  # (T-1, b, b)


def local_tsqr(A: torch.Tensor, tile_rows: int) -> Tuple[ChainFactors, torch.Tensor]:
    """Sequential TSQR of A (m, b) over row tiles of ``tile_rows`` rows
    (>= b); a ragged last tile is zero-padded, which is exact. Returns the
    chain factors and the final R (b, b)."""
    m, b = A.shape
    assert tile_rows >= b, (m, b, tile_rows)
    m_pad = -(-m // tile_rows) * tile_rows
    if m_pad != m:
        A = F.pad(A, (0, 0, 0, m_pad - m))
    tiles = A.reshape(m_pad // tile_rows, tile_rows, b)

    leaf = householder_qr(tiles[0])
    R = leaf.R
    Ys, Ts = [], []
    for tile in tiles[1:]:
        wy = householder_qr(torch.cat([R, tile], dim=0))
        R = wy.R
        Ys.append(wy.Y)
        Ts.append(wy.T)
    if Ys:
        step_Y, step_T = torch.stack(Ys), torch.stack(Ts)
    else:
        step_Y = A.new_zeros((0, b + tile_rows, b))
        step_T = A.new_zeros((0, b, b))
    return ChainFactors(leaf.Y, leaf.T, step_Y, step_T), R


def local_tsqr_q(factors: ChainFactors, tile_rows: int) -> torch.Tensor:
    """The thin Q (m_pad, b) of a ``local_tsqr`` chain, walking the chain
    from its root back to the leaf."""
    b = factors.leaf_T.shape[-1]
    E = torch.eye(b, dtype=factors.leaf_Y.dtype, device=factors.leaf_Y.device)
    F_tiles = []
    for Y, T in zip(reversed(factors.step_Y), reversed(factors.step_T)):
        out = apply_q(Y, T, torch.cat([E, E.new_zeros((tile_rows, b))], dim=0))
        E = out[:b]
        F_tiles.append(out[b:])
    pad = torch.cat([E, E.new_zeros((tile_rows - b, b))], dim=0)
    F0 = apply_q(factors.leaf_Y, factors.leaf_T, pad)
    return torch.cat([F0] + F_tiles[::-1], dim=0)


def tsqr_orthonormalize(A: torch.Tensor, tile_rows: int):
    """Thin Q, R of tall-skinny A via the sequential chain."""
    factors, R = local_tsqr(A, tile_rows)
    return local_tsqr_q(factors, tile_rows)[: A.shape[0]], R


# ---------------------------------------------------------------------------
# Distributed TSQR over a Comm.
# ---------------------------------------------------------------------------


class DistTSQRFactors(NamedTuple):
    """Per-lane factors of a distributed TSQR: the leaf WY, the combine
    factors along the lane's path (leading ``levels`` axis; zeroed entries
    are pass-through combines) and the final R."""

    leaf_Y: torch.Tensor
    leaf_T: torch.Tensor
    level_Y2: torch.Tensor
    level_T: torch.Tensor
    R: torch.Tensor


def _xor_perm(P: int, step: int) -> Sequence[Tuple[int, int]]:
    return [(i, i ^ (1 << step)) for i in range(P)]


def _levels(P: int) -> int:
    assert P & (P - 1) == 0, f"TSQR axis must be a power of two, got {P}"
    return P.bit_length() - 1


def _stack_levels(xs, like: torch.Tensor) -> torch.Tensor:
    if xs:
        return torch.stack(xs)
    return like.new_zeros((0,) + tuple(like.shape))


def ft_tsqr_level(comm, R: torch.Tensor, step: int, target, active_threshold,
                  qr=stacked_qr):
    """One level of the FT butterfly over current R factors: the pair
    exchanges R and both lanes compute the identical stacked QR. Returns
    ``(R_next, Y2, T)`` with the group-activity masking applied (zeroed
    factors are pass-throughs; a group of 2^step lanes is consumed iff its
    last lane is below ``active_threshold``). ``qr`` computes the stacked
    QR (K3 by default; ``fused_panel_math`` passes the plain version)."""
    idx = comm.axis_index()
    P = comm.axis_size()
    R_buddy = comm.ppermute(R, _xor_perm(P, step))
    tbit = (target >> step) & 1
    is_top = ((idx >> step) & 1) == tbit
    R_top = comm.where(is_top, R, R_buddy)
    R_bot = comm.where(is_top, R_buddy, R)
    sq = qr(R_top, R_bot)
    group = 1 << step
    my_base = idx & ~(group - 1)
    sib_base = (idx ^ group) & ~(group - 1)
    my_dead = my_base + group <= active_threshold
    sib_dead = sib_base + group <= active_threshold
    both_live = ~my_dead & ~sib_dead
    R_next = comm.where(both_live, sq.R, comm.where(my_dead, R_buddy, R))
    Y2 = comm.where(both_live, sq.Y2, torch.zeros_like(sq.Y2))
    T = comm.where(both_live, sq.T, torch.zeros_like(sq.T))
    return R_next, Y2, T


def ft_tsqr_combine(comm, R: torch.Tensor, target, active_threshold=0):
    """The FT butterfly over already-computed leaf R factors, oriented so
    the tree root is lane ``target``. Returns (level_Y2, level_T, R_final)
    with a leading ``levels`` axis on the factor stacks."""
    Y2s, Ts = [], []
    for step in range(_levels(comm.axis_size())):
        R, Y2, T = ft_tsqr_level(comm, R, step, target, active_threshold)
        Y2s.append(Y2)
        Ts.append(T)
    return _stack_levels(Y2s, R), _stack_levels(Ts, R), R


def ft_tsqr(A_local: torch.Tensor, comm, target: int | None = None
            ) -> DistTSQRFactors:
    """The paper's FT-TSQR butterfly: after log2 P levels every lane holds
    the final R. Short lanes (m_loc < b) are zero-padded to b rows."""
    P = comm.axis_size()
    if target is None:
        target = P - 1
    m_loc, b = comm.local_shape(A_local)
    if m_loc < b:
        A_local = F.pad(A_local, (0, 0, 0, b - m_loc))
    leaf = householder_qr(A_local)
    level_Y2, level_T, R = ft_tsqr_combine(comm, leaf.R, target)
    return DistTSQRFactors(leaf.Y, leaf.T, level_Y2, level_T, R)


def baseline_tsqr(A_local: torch.Tensor, comm, broadcast_r: bool = False
                  ) -> DistTSQRFactors:
    """Classical one-directional reduction tree: at level s only lanes with
    the low s+1 index bits zero receive and compute; senders carry zeros.
    Only lane 0 holds R; ``broadcast_r`` adds the broadcast."""
    P = comm.axis_size()
    levels = _levels(P)
    idx = comm.axis_index()
    leaf = householder_qr(A_local)
    R = leaf.R
    Y2s, Ts = [], []
    for step in range(levels):
        stride, group = 1 << step, 1 << (step + 1)
        perm = [(i, i - stride) for i in range(P) if i % group == stride]
        R_from_buddy = comm.ppermute(R, perm)
        is_receiver = (idx % group) == 0
        sq = stacked_qr(R, R_from_buddy)
        R = comm.where(is_receiver, sq.R, torch.zeros_like(sq.R))
        Y2s.append(comm.where(is_receiver, sq.Y2, torch.zeros_like(sq.Y2)))
        Ts.append(comm.where(is_receiver, sq.T, torch.zeros_like(sq.T)))
    if broadcast_r and levels:
        R = comm.psum(comm.where(idx == 0, R, torch.zeros_like(R)))
    return DistTSQRFactors(leaf.Y, leaf.T, _stack_levels(Y2s, R),
                           _stack_levels(Ts, R), R)


def ft_tsqr_q(factors: DistTSQRFactors, comm, target: int | None = None
              ) -> torch.Tensor:
    """This lane's block of the thin Q from FT-TSQR factors: a top-down
    walk of the butterfly, then the leaf reflectors."""
    P = comm.axis_size()
    if target is None:
        target = P - 1
    idx = comm.axis_index()
    b = comm.local_shape(factors.R)[-1]
    eye = torch.eye(b, dtype=factors.R.dtype, device=factors.R.device)
    eye = eye.expand(factors.R.shape).contiguous()
    E = comm.where(idx == target, eye, torch.zeros_like(eye))
    for step in reversed(range(_levels(P))):
        E_buddy = comm.ppermute(E, _xor_perm(P, step))
        tbit = (target >> step) & 1
        is_top = ((idx >> step) & 1) == tbit
        E_top = comm.where(is_top, E, E_buddy)
        E_bot = comm.where(is_top, E_buddy, E)
        Y2, T = factors.level_Y2[step], factors.level_T[step]
        new_top, new_bot = stacked_apply_q(StackedQR(Y2, T, T), E_top, E_bot)
        E = comm.where(is_top, new_top, new_bot)
    m_loc = comm.local_shape(factors.leaf_Y)[0]
    pad = F.pad(E, (0, 0, 0, m_loc - b))
    return apply_q(factors.leaf_Y, factors.leaf_T, pad)


def dist_orthonormalize(A_local: torch.Tensor, comm):
    """Distributed thin-QR orthonormalization: returns (Q_local, R), R
    replicated on every lane; pad rows of short lanes are sliced off."""
    m_loc = comm.local_shape(A_local)[0]
    factors = ft_tsqr(A_local, comm)
    Q = ft_tsqr_q(factors, comm)
    return Q[:, :m_loc], factors.R


# Convenience SPMD wrappers (every rank of the group calls them) -------------


def ft_tsqr_spmd(A_local: torch.Tensor, group=None) -> DistTSQRFactors:
    """``ft_tsqr`` in one rank of ``group`` (a process group, None for the
    default group, or an ``AxisComm``) on this rank's block ``(m_loc, b)``
    or ``(1, m_loc, b)``."""
    return ft_tsqr(lane_block(A_local), axis_comm(group))


def dist_orthonormalize_spmd(A_local: torch.Tensor, group=None):
    """``dist_orthonormalize`` in one rank of ``group``: this rank's block
    of Q and the replicated R, each with a unit lane axis."""
    return dist_orthonormalize(lane_block(A_local), axis_comm(group))
