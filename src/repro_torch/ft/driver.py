"""Fault-tolerant execution driver for the windowed CAQR sweep, paper §II-III
(port of ``src/repro/ft/driver.py``).

The end-to-end form of the paper's claim: run the entire windowed FT-CAQR
sweep while lanes die at scheduled points (any panel, after the leaf or
any TSQR butterfly or trailing-combine level) and finish with ``R``, the
per-panel implicit-Q factors and the recovery bundles **bit-identical** to
the failure-free run.

The sweep is the state machine of ``repro_torch.ft.online.state``; this
driver is a loop over ``sweep_step`` that fires the scheduled deaths at
each boundary. Death (``obliterate_state``) NaN-poisons every float the
lane holds except the re-readable initial matrix, so any read of dead
state breaks the bit-identity. REBUILD (``rebuild_state``) respawns the
lane from (a) its own slice of the initial matrix and (b) per lost
artifact, the state of exactly ONE surviving lane, its XOR buddy at the
relevant tree level; every recompute goes through the failure-free path's
kernels (K1 leaf, K2 apply, K4 pair combine), whose bits do not depend on
how many lanes share a launch, so the rebuilt lane equals the lane that
died. Each event's ledger records which survivor each artifact came from.

Where the port departs from the JAX package: there, the replay runs on
every lane through ``comm.map_local`` (a vmap) and keeps only the dead
lane's result. The port's ``SimComm.map_local`` is the identity and the
sweep-level primitives of ``repro_torch.core.recovery`` take one lane's
2-D rows, so the port replays only the dead lane's slice, where
``comm.holds(lane)``, and writes it back with ``where_lane``. Every read
of another lane is ``fetch_lane`` or ``recv_lane`` from the source the
ledger names: under ``SimComm`` an index (a view), under ``AxisComm``
(one lane a process) one point-to-point transfer in which only that
source sends and only the rebuilt rank computes the replay. SHRINK and
BLANK delegate to the scheduled elastic driver
(``repro_torch.ft.elastic.ft_caqr_sweep_elastic``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import AbstractSet, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import recovery as rec
from repro_torch.core.caqr import PanelFactors, lane_geometry
from repro_torch.core.householder import apply_qt
from repro_torch.core.trailing import RecoveryBundle
from repro_torch.core.tsqr import _levels
from repro_torch.ft.coding import CodingScheme, XORPairScheme
from repro_torch.ft.failures import (
    Detector,
    FailureSchedule,
    PHASE_TSQR,
    PHASE_TRAILING,
    UnrecoverableFailure,
)
from repro_torch.ft.online.state import (
    SweepState,
    finalize,
    initial_sweep_state,
    map_state,
    state_lane_axes,
    sweep_step,
)
from repro_torch.ft.semantics import Semantics


@dataclasses.dataclass
class RecoveryEvent:
    """One REBUILD: which lane died where, the single-source read ledger
    (artifact name -> the one surviving lane it was fetched from), and the
    REBUILD's wall-clock seconds (the device synchronised before and after
    when the state lies on the GPU)."""

    point: Tuple[int, str, int]
    lane: int
    reads: Dict[str, int]
    elapsed_s: float

    @property
    def sources(self) -> List[int]:
        return sorted(set(self.reads.values()))


class FTSweepResult(NamedTuple):
    """Same layout as ``CAQRResult(collect_bundles=True)`` plus the
    recovery event log."""

    R: torch.Tensor
    factors: PanelFactors
    bundles: RecoveryBundle
    events: List[RecoveryEvent]


# -- death + REBUILD as SweepState transitions -------------------------------


def obliterate_state(comm, state: SweepState, lane: int) -> SweepState:
    """Process death: NaN every float the lane holds (current block-row,
    in-flight panel state, and its slices of all stored sweep outputs).
    The initial matrix ``A0`` is the re-readable data source and survives."""
    axes = state_lane_axes(state).replace(A0=-1)
    return map_state(
        lambda x, ax: x if ax < 0 else comm.poison(x, lane, lane_axis=ax),
        state, axes)


_XOR_SCHEME = XORPairScheme()


def recover_lanes(
    comm,
    state: SweepState,
    newly: List[int],
    point: Tuple[int, str, int],
    dead: AbstractSet[int],
    sync=None,
    on_recovered=None,
    scheme: Optional[CodingScheme] = None,
) -> Tuple[SweepState, List[RecoveryEvent]]:
    """The REBUILD protocol: all detected deaths strike first, then
    recovery runs. One newly dead lane takes the paper's single-source XOR
    REBUILD; ``2 <= t <= scheme.f`` simultaneous deaths take the scheme's
    joint decode (``MDSScheme``); otherwise the per-lane loop runs, and
    a needed source that is itself dead raises ``UnrecoverableFailure``
    (naming the scheme's ``f`` when ``t > f``). ``sync(state)`` (optional)
    drains the device before and after each rebuild so ``elapsed_s``
    covers only the rebuild; ``on_recovered(lane)`` runs after a lane is
    rebuilt."""
    scheme = _XOR_SCHEME if scheme is None else scheme
    events: List[RecoveryEvent] = []
    newly = sorted(newly)
    for lane in newly:
        state = obliterate_state(comm, state, lane)
    if (scheme.joint and 2 <= len(newly) <= scheme.f
            and not (set(dead) - set(newly))):
        if sync is not None:
            sync(state)
        t0 = time.perf_counter()
        state, reads = scheme.decode_lanes(comm, state, newly, dead)
        if sync is not None:
            sync(state)
        elapsed = time.perf_counter() - t0
        for lane in newly:
            if on_recovered is not None:
                on_recovered(lane)
            events.append(RecoveryEvent(point=point, lane=lane,
                                        reads=dict(reads), elapsed_s=elapsed))
        return state, events
    try:
        for lane in newly:
            if sync is not None:
                sync(state)
            t0 = time.perf_counter()
            state, reads = rebuild_state(comm, state, lane, point, dead)
            if sync is not None:
                sync(state)
            if on_recovered is not None:
                on_recovered(lane)
            events.append(RecoveryEvent(point=point, lane=lane, reads=reads,
                                        elapsed_s=time.perf_counter() - t0))
    except UnrecoverableFailure as e:
        if scheme.joint and len(newly) > scheme.f:
            raise UnrecoverableFailure(
                f"{len(newly)} simultaneous deaths exceed the coding "
                f"scheme's tolerance f={scheme.f}, and the XOR fallback "
                f"found no live source: {e}") from None
        raise
    return state, events


def rebuild_state(
    comm,
    state: SweepState,
    lane: int,
    point: Tuple[int, str, int],
    dead: AbstractSet[int] = frozenset(),
) -> Tuple[SweepState, Dict[str, int]]:
    """The paper's REBUILD as a state transition: respawn ``lane`` at the
    boundary ``point``, re-read its initial slice, replay the completed
    panels, restore the in-flight panel state, each lost artifact from
    exactly one surviving buddy. Returns the repaired state and the
    single-source read ledger. A needed source in ``dead`` raises
    ``UnrecoverableFailure``."""
    geom = state.geom
    b, m_loc = geom.b, geom.m_loc_pad
    reads: Dict[str, int] = {}

    def fetch(artifact: str, source: int) -> int:
        if source == lane or source in dead:
            raise UnrecoverableFailure(
                f"rebuilding lane {lane} at {point} needs {artifact} "
                f"from lane {source}, which is not a live survivor")
        reads[artifact] = source
        return source

    k = point[0]
    # respawn: the lane re-reads its own (padded) slice of the data source;
    # only the process holding the lane computes the replay (``mine``)
    mine = comm.holds(lane)
    rows = comm.lane_slice(state.A0, lane) if mine else None
    for j in range(k):
        state, rows = _replay_panel(comm, state, j, lane, rows, fetch)

    # current panel: recompute the masked leaf from the rebuilt rows
    col0, t_lane, rs, act = lane_geometry(k, b, m_loc, lane)
    lY = lT = lR = None
    if mine:
        lY, lT, lR = rec.recompute_leaf(rows, col0, b, rs, act)
    state = state.replace(
        leaf_Y=comm.where_lane(lane, lY, state.leaf_Y),
        leaf_T=comm.where_lane(lane, lT, state.leaf_T),
        R_leaf=comm.where_lane(lane, lR, state.R_leaf),
        A=comm.where_lane(lane, rows, state.A),
        window=comm.where_lane(lane, rows[:, col0:] if mine else None,
                               state.window),
    )

    _, phase, lvl = point
    if phase == PHASE_TSQR:
        # ladder + running R: identical at the level-0 buddy (lanes i and
        # i^1 agree at every level), so one copy restores every level
        src = fetch("tsqr.ladder+R", lane ^ 1)
        Y2s, Ts = list(state.Y2s), list(state.Ts)
        for i in range(lvl + 1):
            Y2s[i] = comm.fetch_lane(Y2s[i], lane, src)
            Ts[i] = comm.fetch_lane(Ts[i], lane, src)
        state = state.replace(
            Y2s=tuple(Y2s), Ts=tuple(Ts),
            R_carry=comm.fetch_lane(state.R_carry, lane, src))
    elif phase == PHASE_TRAILING:
        src = fetch("tsqr.ladder", lane ^ 1)
        level_Y2 = comm.fetch_lane(state.level_Y2, lane, src, lane_axis=1)
        level_T = comm.fetch_lane(state.level_T, lane, src, lane_axis=1)
        # the per-level ladder and the running R ride along from the same
        # survivor, so the respawned lane holds no stale NaN
        Y2s, Ts = list(state.Y2s), list(state.Ts)
        for i in range(len(Y2s)):
            Y2s[i] = comm.fetch_lane(Y2s[i], lane, src)
            Ts[i] = comm.fetch_lane(Ts[i], lane, src)
        state = state.replace(Y2s=tuple(Y2s), Ts=tuple(Ts))
        if state.R_carry is not None:
            state = state.replace(
                R_carry=comm.fetch_lane(state.R_carry, lane, src))
        # the leaf-applied window: a local recompute (one-lane K2)
        C_local = comm.where_lane(
            lane, apply_qt(lY, lT, rows[:, col0:]) if mine else None,
            state.C_local)
        # C' after the last completed level: ONE fetch from that level's
        # buddy, replayed through the pair combine (one-lane K4)
        src_c = fetch(f"trailing.cprime@level{lvl}", lane ^ (1 << lvl))
        failed_was_top = ((lane >> lvl) & 1) == ((t_lane >> lvl) & 1)
        pair_live = lane >= t_lane and src_c >= t_lane
        cb = comm.recv_lane(state.Cs_buddy[lvl], lane, src_c)
        cs = comm.recv_lane(state.Cs_self[lvl], lane, src_c)
        cp = None
        if mine:
            cp = rec.rebuild_cprime_after_level(
                cb, cs, comm.lane_slice(level_Y2[lvl], lane),
                comm.lane_slice(level_T[lvl], lane), failed_was_top,
                pair_live)
        C_prime = comm.where_lane(lane, cp, state.C_prime)
        # the lane's own bundle rows: mirror of each level-buddy's entry
        # (W is pair-shared; C_self/C_buddy swap sides)
        Ws = list(state.Ws)
        Cs_self, Cs_buddy = list(state.Cs_self), list(state.Cs_buddy)
        for s in range(lvl + 1):
            src_s = fetch(f"trailing.bundle@level{s}", lane ^ (1 << s))
            new_w = comm.fetch_lane(Ws[s], lane, src_s)
            new_cs = comm.fetch_lane(Cs_buddy[s], lane, src_s, into=Cs_self[s])
            new_cb = comm.fetch_lane(Cs_self[s], lane, src_s, into=Cs_buddy[s])
            Ws[s], Cs_self[s], Cs_buddy[s] = new_w, new_cs, new_cb
        state = state.replace(
            level_Y2=level_Y2, level_T=level_T, C_local=C_local,
            C_prime=C_prime, Ws=tuple(Ws),
            Cs_self=tuple(Cs_self), Cs_buddy=tuple(Cs_buddy),
        )
    return state, reads


def _replay_panel(comm, state: SweepState, j: int, lane: int,
                  rows: Optional[torch.Tensor], fetch
                  ) -> Tuple[SweepState, Optional[torch.Tensor]]:
    """Advance the respawned lane's block-row ``rows`` (m_loc_pad, n_work;
    None where this process does not hold the lane) through completed
    panel ``j`` and restore its slices of that panel's stored outputs."""
    geom = state.geom
    b, m_loc, L = geom.b, geom.m_loc_pad, geom.levels
    mine = comm.holds(lane)
    col0, t_lane, rs, act = lane_geometry(j, b, m_loc, lane)
    lY = lT = None
    if mine:
        lY, lT, _lR = rec.recompute_leaf(rows, col0, b, rs, act)

    src_l = fetch(f"panel{j}.tsqr_ladder", lane ^ 1)
    factors = list(state.factors)
    fj = factors[j]
    factors[j] = PanelFactors(
        leaf_Y=comm.where_lane(lane, lY, fj.leaf_Y),
        leaf_T=comm.where_lane(lane, lT, fj.leaf_T),
        level_Y2=comm.fetch_lane(fj.level_Y2, lane, src_l, lane_axis=1),
        level_T=comm.fetch_lane(fj.level_T, lane, src_l, lane_axis=1),
        row_start=fj.row_start, active=fj.active, target=fj.target,
    )
    src_r = fetch(f"panel{j}.r_rows", lane ^ 1)
    R_rows = list(state.R_rows)
    R_rows[j] = comm.fetch_lane(R_rows[j], lane, src_r)

    # final C' of panel j: one fetch from the last-level buddy's bundle,
    # sliced back from full width to the panel's live window
    bj = state.bundles[j]
    cp = None
    if act:
        src_c = fetch(f"panel{j}.cprime_final", lane ^ (1 << (L - 1)))
        failed_was_top = ((lane >> (L - 1)) & 1) == ((t_lane >> (L - 1)) & 1)
        pair_live = lane >= t_lane and src_c >= t_lane
        got = [comm.recv_lane(x, lane, src_c) for x in (
            bj.C_buddy[L - 1][..., col0:], bj.C_self[L - 1][..., col0:],
            bj.Y2[L - 1], bj.T[L - 1])]
        if mine:
            cb, cs, y2, t = got
            cp = rec.rebuild_cprime_after_level(
                cb.contiguous(), cs.contiguous(), y2, t, failed_was_top,
                pair_live)
    if mine:
        rows = rec.rebuild_block_row_through_panel(rows, lY, lT, cp, col0,
                                                   rs, act)

    # the lane's own bundle rows for panel j: per-level mirrors
    W_lv = [bj.W[s] for s in range(L)]
    Cs_lv = [bj.C_self[s] for s in range(L)]
    Cb_lv = [bj.C_buddy[s] for s in range(L)]
    for s in range(L):
        src_s = fetch(f"panel{j}.bundle@level{s}", lane ^ (1 << s))
        W_lv[s] = comm.fetch_lane(bj.W[s], lane, src_s)
        Cs_lv[s] = comm.fetch_lane(bj.C_buddy[s], lane, src_s, into=Cs_lv[s])
        Cb_lv[s] = comm.fetch_lane(bj.C_self[s], lane, src_s, into=Cb_lv[s])
    bundles = list(state.bundles)
    bundles[j] = RecoveryBundle(
        W=torch.stack(W_lv), C_self=torch.stack(Cs_lv),
        C_buddy=torch.stack(Cb_lv),
        Y2=comm.fetch_lane(bj.Y2, lane, src_l, lane_axis=1),
        T=comm.fetch_lane(bj.T, lane, src_l, lane_axis=1),
        self_was_top=bj.self_was_top,
    )
    state = state.replace(
        factors=tuple(factors), R_rows=tuple(R_rows), bundles=tuple(bundles))
    return state, rows


# -- the scheduled driver ----------------------------------------------------


def _block_on_state(state: SweepState) -> None:
    if state.A.is_cuda:
        torch.cuda.synchronize(state.A.device)


class FTSweepDriver:
    """Level-stepped windowed CAQR sweep with failure injection + REBUILD:
    a loop over ``sweep_step`` that fires the scheduled deaths of each
    just-completed point and repairs them with ``recover_lanes``.

    ``A0`` is the initial matrix in the SimComm layout ``(P, m_loc, n)``,
    any shape ``caqr_factorize`` accepts, and doubles as the re-readable
    data source: a respawned lane re-reads its padded initial slice.
    """

    def __init__(self, A0: torch.Tensor, comm, panel_width: int,
                 schedule: Optional[FailureSchedule] = None,
                 detector: Optional[Detector] = None,
                 scheme: Optional[CodingScheme] = None):
        self.comm = comm
        self.scheme = _XOR_SCHEME if scheme is None else scheme
        self.P = comm.axis_size()
        self.levels = _levels(self.P)
        assert self.levels >= 1, "need at least 2 lanes to tolerate failures"
        self.b = panel_width
        self.state = initial_sweep_state(comm, A0, panel_width)
        self.geom = self.state.geom
        self.detector = detector or Detector(self.P, schedule)
        self.events: List[RecoveryEvent] = []

    def run(self) -> FTSweepResult:
        while self.state.cursor is not None:
            point = self.state.cursor
            self.state = sweep_step(self.comm, self.state)
            self.state = self.scheme.refresh(self.comm, self.state)
            self._checkpoint(point)
        R, factors, bundles = finalize(self.comm, self.state)
        return FTSweepResult(R=R, factors=factors, bundles=bundles,
                             events=self.events)

    def _checkpoint(self, point: Tuple[int, str, int]) -> None:
        newly = self.detector.begin_step(point)
        if not newly:
            return
        self.state, events = recover_lanes(
            self.comm, self.state, newly, point, self.detector.dead,
            sync=_block_on_state, on_recovered=self.detector.revive,
            scheme=self.scheme)
        self.events.extend(events)


def ft_caqr_sweep(
    A0: torch.Tensor,
    comm,
    panel_width: int,
    schedule: Optional[FailureSchedule] = None,
    semantics: Optional[Semantics] = None,
    scheme: Optional[CodingScheme] = None,
) -> FTSweepResult:
    """Run the full windowed FT-CAQR sweep under a failure schedule (paper
    §II-III end to end). Returns ``(R, factors, bundles, events)``,
    bit-identical to ``caqr_factorize(A0, comm, panel_width,
    collect_bundles=True, use_scan=False)`` whatever the (recoverable)
    schedule, with one ``RecoveryEvent`` per REBUILD.

    ``semantics`` selects the continuation policy: REBUILD (default) runs
    this driver; SHRINK and BLANK delegate to the scheduled elastic driver
    (``repro_torch.ft.elastic.ft_caqr_sweep_elastic``), which returns an
    ``ElasticSweepResult`` with a host-spliced R instead. ``scheme``
    selects the redundancy coding: ``XORPairScheme`` (default) or
    ``MDSScheme(f=...)``, whose parity slots recover any ``f``
    simultaneous deaths bitwise. For runtime-detected failures use the
    online orchestrator (``repro_torch.ft.online.orchestrator``).

    Example (kill lane 1 after panel 0's level-0 trailing combine):

    >>> import numpy as np, torch
    >>> from repro_torch.core import SimComm, caqr_factorize
    >>> from repro_torch.ft import FailureSchedule, ft_caqr_sweep, sweep_point
    >>> A = torch.from_numpy(np.random.default_rng(0).standard_normal(
    ...     (2, 4, 4)).astype(np.float32))
    >>> sched = FailureSchedule(events={sweep_point(0, "trailing", 0): [1]})
    >>> out = ft_caqr_sweep(A, SimComm(2), 4, schedule=sched)
    >>> ref = caqr_factorize(A, SimComm(2), 4, collect_bundles=True,
    ...                      use_scan=False)
    >>> bool(torch.equal(out.R, ref.R))
    True
    >>> [(e.point, e.lane) for e in out.events]
    [((0, 'trailing', 0), 1)]
    """
    if semantics is not None and semantics is not Semantics.REBUILD:
        from repro_torch.ft.elastic import ft_caqr_sweep_elastic

        return ft_caqr_sweep_elastic(
            A0, comm, panel_width, schedule=schedule, semantics=semantics,
            scheme=scheme)
    return FTSweepDriver(A0, comm, panel_width, schedule, scheme=scheme).run()
