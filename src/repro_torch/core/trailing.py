"""Trailing-matrix update trees, paper Algorithms 1 and 2 (port of
``src/repro/core/trailing.py``).

After a panel's TSQR the implicit Q^T is applied to the trailing columns
through the same tree: each lane applies its leaf reflectors to its
block-row (K2), then per level the buddy pair combines the top-b rows C'
of their blocks through the level's stacked (Y2, T):
    W = T^T (C'_top + Y2^T C'_bot); C'_top - W; C'_bot - Y2 W.

Unlike the JAX ``_combine``, which under SimComm runs a plain batched
matmul, the port's ``_combine`` sends the lane-batched call to K4, so the
trailing combine runs as a kernel on the single-card path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.householder import StackedQR, _rows_at, apply_qt, stacked_apply_qt
from repro_torch.core.tsqr import DistTSQRFactors, _levels, _stack_levels, _xor_perm
from repro_torch.kernels.backend import to_device


class RecoveryBundle(NamedTuple):
    """What each lane retains per tree level under Algorithm 2: enough to
    rebuild the buddy's update from this lane alone. Arrays carry a leading
    ``levels`` axis, then the lane axis."""

    W: torch.Tensor        # (L, P, b, n) the shared W of each level
    C_self: torch.Tensor   # (L, P, b, n) this lane's C' entering each level
    C_buddy: torch.Tensor  # (L, P, b, n) the buddy's C' received
    Y2: torch.Tensor       # (L, P, b, b)
    T: torch.Tensor        # (L, P, b, b)
    self_was_top: torch.Tensor  # (L, P) bool


def _combine(Y2, T, C_top, C_bot):
    """The paper's W-form combine through K4 (lane-batched or not)."""
    return stacked_apply_qt(StackedQR(Y2=Y2, T=T, R=T), C_top, C_bot)


class TrailingLevelStep(NamedTuple):
    """One trailing-combine level: the advanced C' plus this level's slice
    of the recovery bundle."""

    C_prime: torch.Tensor
    W: torch.Tensor
    C_self: torch.Tensor
    C_buddy: torch.Tensor
    is_top: torch.Tensor


def trailing_combine_level(comm, C_prime, Y2, T, step: int, target,
                           dead_threshold, paper_semantics: bool = False,
                           combine=_combine) -> TrailingLevelStep:
    """One tree level of Algorithm 2: the pair exchanges C', both lanes
    compute W, and each keeps the level's bundle slice. Zeroed (Y2, T) make
    the combine a pass-through; a pair with a dead member (a lane below
    ``dead_threshold``) passes through per lane. ``combine`` is the pair
    combine (K4 by default; ``fused_panel_math`` passes the plain version)."""
    P = comm.axis_size()
    idx = comm.axis_index()
    C_buddy = comm.ppermute(C_prime, _xor_perm(P, step))
    tbit = (target >> step) & 1
    is_top = ((idx >> step) & 1) == tbit
    C_top = comm.where(is_top, C_prime, C_buddy)
    C_bot = comm.where(is_top, C_buddy, C_prime)
    new_top, new_bot, W = combine(Y2, T, C_top, C_bot)
    buddy_idx = idx ^ (1 << step)
    pair_live = (idx >= dead_threshold) & (buddy_idx >= dead_threshold)
    if paper_semantics:
        pair_live = pair_live & ((idx % (1 << step)) == 0)
    W = comm.where(pair_live, W, torch.zeros_like(W))
    C_next = comm.where(is_top, new_top, new_bot)
    C_next = comm.where(pair_live, C_next, C_prime)
    return TrailingLevelStep(C_prime=C_next, W=W, C_self=C_prime,
                             C_buddy=C_buddy, is_top=is_top)


def _leaf_apply(comm, factors: DistTSQRFactors, C_local, row_start,
                active=None, skip_consumed: bool = False, apply=apply_qt):
    """Leaf Q^T apply over all lanes (one K2 launch) and the C' block at
    each lane's ``row_start`` (start clamped as ``lax.dynamic_slice``
    clamps). Fully consumed lanes have an all-zero leaf Y, so their apply
    is the identity. ``active`` and ``skip_consumed`` are the JAX
    package's keywords: there the skip changes only the work under
    shard_map, and under ``SimComm`` (the port's one layout) they change
    nothing, so they are accepted and not read. ``apply`` computes Q^T C
    (K2 by default; ``fused_panel_math`` passes the plain version)."""
    b = comm.local_shape(factors.R)[-1]
    C2 = apply(factors.leaf_Y, factors.leaf_T, C_local)
    rs = to_device(row_start, C2.device).to(torch.int64)
    return C2, _rows_at(C2, rs.expand(C2.shape[0]), b)


def _writeback(comm, C_local, C_prime, row_start, active):
    """Write each active lane's C' back at its (clamped) ``row_start``, in
    place on ``C_local``, which must be a tensor the caller owns: the fresh
    output of the leaf apply here, a fresh concatenation in the state
    machine's deposit. Returns ``C_local``."""
    m, b = C_local.shape[-2], C_prime.shape[-2]
    rs = to_device(row_start, C_local.device).to(torch.int64)
    rs = rs.expand(C_local.shape[0]).clamp(0, m - b)
    blk = _rows_at(C_local, rs, b)
    new = comm.where(active, C_prime, blk)
    rows = rs[:, None] + torch.arange(b, device=C_local.device)
    lanes = torch.arange(C_local.shape[0], device=C_local.device)[:, None]
    C_local[lanes, rows] = new
    return C_local


def trailing_update_ft(C_local, factors: DistTSQRFactors, comm, target=None,
                       row_start=None, active=None, dead_threshold=0,
                       paper_semantics: bool = False):
    """Algorithm 2: the fault-tolerant trailing update.

    C_local: (P, m_loc, n) block-rows (C may be a strided view). factors:
    the panel's FT-TSQR factors. target: the tree root (default P-1).
    row_start / active: per-lane C' offset and participation flag.
    dead_threshold: lanes below it are fully consumed. paper_semantics:
    the paper's exact Algorithm 2, where the sender retires after its
    level. Factors built on zero-padded lanes carry more leaf rows than C:
    C is zero-row-padded to conform and the padded layout is returned.

    Returns (updated block-rows, per-level recovery bundle, final C').
    """
    P = comm.axis_size()
    levels = _levels(P)
    idx = comm.axis_index()
    m_fac = comm.local_shape(factors.leaf_Y)[0]
    m_c = comm.local_shape(C_local)[0]
    if m_c != m_fac:
        assert m_c < m_fac, (m_c, m_fac)
        C_local = F.pad(C_local, (0, 0, 0, m_fac - m_c))
    if target is None:
        target = P - 1
    if row_start is None:
        row_start = idx * 0
    if active is None:
        active = idx >= 0

    C_local, C_prime = _leaf_apply(comm, factors, C_local, row_start)
    C_prime = comm.where(active, C_prime, torch.zeros_like(C_prime))

    Ws, Cs_self, Cs_buddy, tops = [], [], [], []
    for step in range(levels):
        out = trailing_combine_level(
            comm, C_prime, factors.level_Y2[step], factors.level_T[step],
            step, target, dead_threshold, paper_semantics=paper_semantics)
        Ws.append(out.W)
        Cs_self.append(out.C_self)
        Cs_buddy.append(out.C_buddy)
        tops.append(out.is_top)
        C_prime = out.C_prime

    C_out = _writeback(comm, C_local, C_prime, row_start, active)

    bundle = RecoveryBundle(
        W=_stack_levels(Ws, C_prime),
        C_self=_stack_levels(Cs_self, C_prime),
        C_buddy=_stack_levels(Cs_buddy, C_prime),
        Y2=factors.level_Y2,
        T=factors.level_T,
        self_was_top=_stack_levels(tops, idx >= 0).to(C_prime.device),
    )
    return C_out, bundle, C_prime


def trailing_update_baseline(C_local, factors: DistTSQRFactors, comm):
    """Algorithm 1: the one-directional tree. At level s the odd lane of a
    pair sends C' up, the even lane computes W and sends V = Y2 W back; the
    odd lane then retires. Single panel, fixed odd-on-top orientation."""
    P = comm.axis_size()
    idx = comm.axis_index()
    row_start = idx * 0
    C_local, C_prime = _leaf_apply(comm, factors, C_local, row_start)
    for step in range(_levels(P)):
        stride, group = 1 << step, 1 << (step + 1)
        up = [(i, i - stride) for i in range(P) if i % group == stride]
        C_from_odd = comm.ppermute(C_prime, up)
        is_even = (idx % group) == 0
        Y2, T = factors.level_Y2[step], factors.level_T[step]
        even_new, _, W = _combine(Y2, T, C_prime, C_from_odd)
        V = Y2 @ W
        down = [(i - stride, i) for i in range(P) if i % group == stride]
        V_from_even = comm.ppermute(V, down)
        is_odd = (idx % group) == stride
        odd_update = C_prime - V_from_even
        C_prime = comm.where(is_even, even_new,
                             comm.where(is_odd, odd_update, C_prime))
    return _writeback(comm, C_local, C_prime, row_start, idx >= 0)
