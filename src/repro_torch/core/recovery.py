"""Failure injection and single-source recovery (port of
``src/repro/core/recovery.py``).

REBUILD semantics: a failed lane is respawned and its state rebuilt from
its own slice of the initial matrix plus the recovery bundle of exactly
ONE surviving lane, its buddy at the current tree level.

All recompute goes through the same kernels as the failure-free path
(K1 ``householder_qr_masked``, K2 ``apply_qt``, K4 ``_combine``), and the
kernels' bits do not depend on the lane or on how many lanes share a
launch, so a rebuilt lane is bit-identical to what the dead lane computed.
For that reason the port's ``recover_cprime`` replays the pair combine
through K4 (as ``rebuild_cprime_after_level`` does) instead of the JAX
package's plain ``C_failed - Y2 @ W``; the replay needs the source's own
entering C', which ``LevelBundle`` therefore also keeps (``C_self``, the
field Algorithm 2's bundle has in ``RecoveryBundle`` too).

The single-panel level machine (``trailing_begin`` .. ``run_ft_trailing``)
indexes lanes, so it runs in the ``SimComm`` layout, as the reference's
does. The sweep-level primitives at the end take one lane's own data and
the values read from ONE source, so ``repro_torch.ft.driver`` runs them
under either comm (under ``AxisComm`` the source's values arrive by one
point-to-point transfer).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.comm import SimComm
from repro_torch.core.householder import apply_qt, householder_qr_masked
from repro_torch.core.trailing import _combine
from repro_torch.core.tsqr import DistTSQRFactors, _levels, _xor_perm


class LaneState(NamedTuple):
    """Per-lane trailing-update state between tree levels."""

    C_local: torch.Tensor  # (P, m_loc, n) leaf-updated block-rows
    C_prime: torch.Tensor  # (P, b, n) current C' per lane
    level: int


class LevelBundle(NamedTuple):
    """Recovery bundle each lane stores after completing a level."""

    W: torch.Tensor        # (P, b, n)
    C_buddy: torch.Tensor  # (P, b, n) the buddy's C' entering the level
    Y2: torch.Tensor       # (P, b, b)
    T: torch.Tensor        # (P, b, b)
    buddy_was_top: torch.Tensor  # (P,) bool
    C_self: torch.Tensor   # (P, b, n) this lane's C' entering the level


def trailing_begin(C_stacked: torch.Tensor, factors: DistTSQRFactors, comm
                   ) -> LaneState:
    """Leaf Q^T apply (one K2 launch); C' = the top b rows."""
    b = factors.R.shape[-1]
    C_local = apply_qt(factors.leaf_Y, factors.leaf_T, C_stacked)
    return LaneState(C_local=C_local, C_prime=C_local[:, :b].contiguous(),
                     level=0)


def trailing_level(state: LaneState, factors: DistTSQRFactors, comm,
                   target: Optional[int] = None
                   ) -> Tuple[LaneState, LevelBundle]:
    """One tree level of Algorithm 2 on all lanes (one K4 launch)."""
    P = comm.axis_size()
    if target is None:
        target = P - 1
    step = state.level
    idx = comm.axis_index()
    C_prime = state.C_prime
    C_buddy = comm.ppermute(C_prime, _xor_perm(P, step))
    is_top = ((idx >> step) & 1) == ((target >> step) & 1)
    C_top = comm.where(is_top, C_prime, C_buddy)
    C_bot = comm.where(is_top, C_buddy, C_prime)
    Y2, T = factors.level_Y2[step], factors.level_T[step]
    new_top, new_bot, W = _combine(Y2, T, C_top, C_bot)
    C_next = comm.where(is_top, new_top, new_bot)
    bundle = LevelBundle(W=W, C_buddy=C_buddy, Y2=Y2, T=T,
                         buddy_was_top=~is_top, C_self=C_prime)
    return LaneState(state.C_local, C_next, step + 1), bundle


def trailing_finish(state: LaneState) -> torch.Tensor:
    b = state.C_prime.shape[-2]
    out = state.C_local.clone()
    out[:, :b] = state.C_prime
    return out


def kill_lane(state: LaneState, lane: int) -> LaneState:
    """Process death: the lane's state is obliterated (NaN)."""
    C_local, C_prime = state.C_local.clone(), state.C_prime.clone()
    C_local[lane] = float("nan")
    C_prime[lane] = float("nan")
    return LaneState(C_local, C_prime, state.level)


def recover_cprime(bundle: LevelBundle, failed: int, source: int
                   ) -> torch.Tensor:
    """Rebuild the failed lane's post-level C' from the bundle of ONE
    surviving lane (its buddy at that level), reading only
    ``bundle[source]``: the pair combine is replayed through K4 on the
    source's copies of both entering C' blocks."""
    return rebuild_cprime_after_level(
        bundle.C_buddy[source], bundle.C_self[source], bundle.Y2[source],
        bundle.T[source], failed_was_top=bool(bundle.buddy_was_top[source]),
        pair_live=True)


def recover_lane_local(A_slice: torch.Tensor, factors_leaf_Y: torch.Tensor,
                       factors_leaf_T: torch.Tensor) -> torch.Tensor:
    """Rebuild the failed lane's leaf-updated block-row from its slice of
    the initial matrix and its leaf factors (one-lane K2 launch)."""
    return apply_qt(factors_leaf_Y, factors_leaf_T, A_slice)


def inject_and_recover(state: LaneState, bundle: LevelBundle, failed: int,
                       A_slice: torch.Tensor, factors: DistTSQRFactors
                       ) -> Tuple[LaneState, int]:
    """Kill ``failed`` after a level, then run the REBUILD recovery from
    its XOR buddy at the completed level. Returns the repaired state and
    the single source lane that was read."""
    assert state.level >= 1, "leaf-level failure is handled by recompute"
    dead = kill_lane(state, failed)
    source = failed ^ (1 << (state.level - 1))
    C_local = dead.C_local
    C_local[failed] = recover_lane_local(
        A_slice, factors.leaf_Y[failed], factors.leaf_T[failed])
    C_prime = dead.C_prime
    C_prime[failed] = recover_cprime(bundle, failed, source)
    return LaneState(C_local, C_prime, dead.level), source


# ---------------------------------------------------------------------------
# Sweep-level single-source reconstruction primitives: each receives only
# the respawned lane's own re-read data plus the state of ONE surviving
# lane, and recomputes through the failure-free path's kernels.
# ---------------------------------------------------------------------------


def recompute_leaf(rows: torch.Tensor, col0: int, b: int, row_start: int,
                   active: bool):
    """Recompute a respawned lane's masked leaf factors (K1) from its own
    rebuilt block-row; returns ``(leaf_Y, leaf_T, R_leaf)``."""
    if not active:
        m_loc = rows.shape[0]
        z = rows.new_zeros((b, b))
        return rows.new_zeros((m_loc, b)), z, z.clone()
    wy = householder_qr_masked(rows[:, col0:col0 + b], row_start)
    return wy.Y, wy.T, wy.R


def rebuild_cprime_after_level(C_fail_entering, C_source_entering, Y2, T,
                               failed_was_top: bool, pair_live: bool):
    """The failed lane's C' after a tree level, from its buddy's bundle:
    replay the pair combine through K4 and keep the failed lane's side.
    ``pair_live=False`` is the sweep's per-lane pass-through."""
    if not pair_live:
        return C_fail_entering
    C_top = C_fail_entering if failed_was_top else C_source_entering
    C_bot = C_source_entering if failed_was_top else C_fail_entering
    new_top, new_bot, _W = _combine(Y2, T, C_top, C_bot)
    return new_top if failed_was_top else new_bot


def rebuild_block_row_through_panel(rows, leaf_Y, leaf_T, C_prime_final,
                                    col0: int, row_start: int, active: bool):
    """Advance a respawned lane's block-row through one completed panel:
    re-apply the leaf reflectors to the live window (K2) and write back the
    recovered final C'."""
    window = apply_qt(leaf_Y, leaf_T, rows[:, col0:])
    if active:
        window[row_start:row_start + C_prime_final.shape[0]] = C_prime_final
    return torch.cat([rows[:, :col0], window], dim=1)


def xor_buddy(lane: int, level: int) -> int:
    """The XOR butterfly partner of ``lane`` at ``level`` (a copy of
    ``src/repro/ft/coding.py::xor_buddy``)."""
    return lane ^ (1 << level)


def pairing_table(P: int) -> List[Sequence[Tuple[int, int]]]:
    """One ppermute permutation per butterfly level of a P-lane world (a
    copy of ``src/repro/ft/coding.py::pairing_table``)."""
    return [_xor_perm(P, s) for s in range(_levels(P))]


def tsqr_recover_r(factors: DistTSQRFactors, failed: int, source: int
                   ) -> torch.Tensor:
    """FT-TSQR recovery: the restarted lane takes R from any single member
    of its redundancy group, where it is bit-identical."""
    return factors.R[source]


def run_ft_trailing(C_stacked: torch.Tensor, factors: DistTSQRFactors, comm,
                    fail_at_level: Optional[int] = None, failed_lane: int = 0,
                    A_stacked: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Drive the level machine end to end, optionally killing and
    recovering one lane after ``fail_at_level`` completes (``SimComm``
    layout)."""
    if not isinstance(comm, SimComm):
        raise NotImplementedError(
            "the single-panel level machine indexes lanes (SimComm layout); "
            "with one process a lane, recovery runs through "
            "repro_torch.ft.driver")
    state = trailing_begin(C_stacked, factors, comm)
    for lvl in range(_levels(comm.axis_size())):
        state, bundle = trailing_level(state, factors, comm)
        if fail_at_level is not None and lvl == fail_at_level:
            assert A_stacked is not None
            state, _src = inject_and_recover(
                state, bundle, failed_lane, A_stacked[failed_lane], factors)
    return trailing_finish(state)
