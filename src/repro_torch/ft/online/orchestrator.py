"""Host-side orchestrator: sweep segments + runtime recovery (port of
``src/repro/ft/online/orchestrator.py``).

The host loops over *segments* of the state machine
(``repro_torch.ft.online.state``), and between segments it

1. runs the registered **fault hooks** (test and demo injectors; in
   production the list is empty),
2. **polls the detector** (``repro_torch.ft.online.detect``): deaths are
   discovered, never scripted,
3. synthesises the **REBUILD** for whatever was found with the scheduled
   driver's ``recover_lanes`` (one ``RecoveryEvent`` per death,
   single-source ledger and all), attributed to the just-completed point,
4. optionally **persists** the state (``push(state)``, e.g.
   ``repro_torch.ckpt.diskless.SweepStateStore``), so a killed
   orchestrator resumes from the last boundary (``from_state``).

A boundary state is bit-identical to the scheduled driver's state at the
same point, so a death found at the boundary after point ``p`` recovers
into exactly the state a ``FailureSchedule({p: [lane]})`` run has after
its REBUILD: the scheduled path is the online path's oracle.

Segments: the JAX package compiles each segment with ``jax.jit``. The
port's ``compiled_segment`` is a process-wide cache of segment runners
under the same key (comm kind, P, points), which issue the kernels'
launches eagerly; ``jit_segments`` keeps its name and both settings run
the same launches. The fused path runs one K6 launch a panel
(``run_panel_fused``). ``step_fn`` stays a plain callable hook for an
external per-point runner.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.ft.coding import CodingScheme, XORPairScheme
from repro_torch.ft.driver import (
    FTSweepResult,
    RecoveryEvent,
    _block_on_state,
    obliterate_state,
    rebuild_state,
    recover_lanes,
)
from repro_torch.ft.elastic import ElasticController
from repro_torch.ft.failures import PHASE_LEAF, LaneFailure, prev_sweep_point
from repro_torch.ft.online.detect import NaNSentinelDetector, OnlineDetector
from repro_torch.ft.online.state import (
    SweepState,
    finalize,
    flat_arrays,
    initial_sweep_state,
    run_panel_fused,
    run_steps,
    state_lane_axes,
)
from repro_torch.ft.semantics import Semantics
from repro_torch.ft.stragglers import (
    SpeculationEvent,
    StragglerMonitor,
    StragglerPolicy,
)

# One segment runner per (comm kind, P, segment size or "fused"), shared by
# every orchestrator in the process.
_SEGMENT_CACHE: Dict[Tuple, Callable] = {}

FaultHook = Callable[[object, SweepState], SweepState]
BoundaryHook = Callable[["SweepOrchestrator"], None]


def compiled_segment(comm, n_points: int) -> Callable[[SweepState], SweepState]:
    """The resident segment runner ``run_steps(comm, state, n_points)``,
    shared by every caller over the same ``(comm kind, P, n_points)``. In
    the port it issues the segment's kernel launches eagerly, as the
    uncompiled path does."""
    key = (type(comm).__name__, comm.axis_size(), n_points)
    fn = _SEGMENT_CACHE.get(key)
    if fn is None:
        def fn(s: SweepState) -> SweepState:
            return run_steps(comm, s, n_points)

        _SEGMENT_CACHE[key] = fn
    return fn


def _fused_segment_runner(comm) -> Callable[[SweepState], SweepState]:
    key = (type(comm).__name__, comm.axis_size(), "fused")
    fn = _SEGMENT_CACHE.get(key)
    if fn is None:
        def fn(s: SweepState) -> SweepState:
            return run_panel_fused(comm, s)

        _SEGMENT_CACHE[key] = fn
    return fn


class SweepOrchestrator:
    """Run the FT-CAQR sweep as host-controlled segments with runtime
    failure detection and REBUILD (the paper's online execution model).

    Parameters
    ----------
    A0, comm, panel_width:
        As ``ft_caqr_sweep`` (SimComm layout ``(P, m_loc, n)``, any general
        shape). Omit them and use :meth:`from_state` to resume a persisted
        state.
    detector:
        ``OnlineDetector`` polled at every boundary (default: the
        NaN-sentinel probe).
    segment_points:
        Sweep points per segment (>= 1): fewer boundaries, a wider
        detection window.
    fused:
        Whole-panel segments (``run_panel_fused``, one K6 launch a panel),
        with boundaries at panel ends, the only legal fused boundaries.
        Bit-identical results. ``segment_points`` only re-aligns a state
        resumed mid-panel. Excludes ``step_fn``.
    jit_segments:
        Route the stepped segments through ``compiled_segment`` (default)
        or call ``run_steps`` directly; both issue the same launches.
    step_fn:
        Optional external segment backend, ``step_fn(state) -> state``
        once per sweep point.
    fault_hooks:
        ``hook(comm, state) -> state`` run at every boundary before the
        detector poll (``ScriptedKiller``, ``WallClockKiller``).
    boundary_hooks:
        ``hook(orchestrator)`` run at every boundary after detection and
        recovery, when the state is healed; changing ``orch.state`` there
        is legal only at a panel boundary.
    store, persist_every:
        With a store, ``store.push(state)`` every ``persist_every``
        boundaries (default 1) and at the final one.
    semantics:
        REBUILD (default); ABORT re-raises the death as ``LaneFailure``;
        SHRINK/BLANK heal the death like REBUILD and then re-mesh the world
        at the next panel boundary (``repro_torch.ft.elastic``), returning
        an ``ElasticSweepResult``.
    elastic_policy:
        Slot policy of a shrunken world, ``"pad"`` (default) or ``"fold"``.
    step_factory:
        With ``step_fn`` and elastic semantics: ``step_factory(n_slots)``
        builds the new world's runner after a transition.
    grow_at:
        Optional sweep point; when it completes, a returning lane re-joins
        at the next panel boundary.
    straggler_monitor, lane_clock:
        A ``StragglerMonitor`` fed ``lane_clock(comm, state)`` (per-lane
        times of the just-run segment). SPECULATE races a buddy recompute
        of a flagged lane's point (bitwise-checked, logged in
        ``self.speculations``); EVICT (or ``escalate_after`` exhausted)
        poisons the lane and escalates to a SHRINK transition.
    scheme:
        The redundancy coding, ``XORPairScheme`` (default) or
        ``MDSScheme(f)``; its ``refresh`` runs at every boundary before
        the hooks and the poll.
    async_segments:
        Double-buffered segments: issue segment N+1 before collecting the
        detector's probe of segment N's boundary (``probe``/``collect``).
        Bitwise-identical to the sync loop: a fault-hook change or a
        detected death throws the speculative segment away and re-issues
        from the recovered state. REBUILD/ABORT only, not fused.
    """

    def __init__(
        self,
        A0=None,
        comm=None,
        panel_width: Optional[int] = None,
        detector: Optional[OnlineDetector] = None,
        *,
        segment_points: int = 1,
        fused: bool = False,
        jit_segments: bool = True,
        step_fn: Optional[Callable[[SweepState], SweepState]] = None,
        fault_hooks: Sequence[FaultHook] = (),
        boundary_hooks: Sequence[BoundaryHook] = (),
        store=None,
        persist_every: Optional[int] = None,
        semantics: Semantics = Semantics.REBUILD,
        state: Optional[SweepState] = None,
        elastic_policy: str = "pad",
        step_factory: Optional[Callable[[int], Callable]] = None,
        grow_at=None,
        straggler_monitor: Optional[StragglerMonitor] = None,
        lane_clock: Optional[Callable] = None,
        scheme: Optional[CodingScheme] = None,
        async_segments: bool = False,
    ):
        assert comm is not None, "comm is required"
        self.comm = comm
        if state is None:
            assert A0 is not None and panel_width is not None, \
                "need (A0, panel_width) or a resume state"
            state = initial_sweep_state(comm, A0, panel_width)
        self.state = state
        self.detector = detector if detector is not None else NaNSentinelDetector()
        assert segment_points >= 1
        self.segment_points = segment_points
        assert not (fused and step_fn is not None), (
            "fused segments replace the per-point runner; pass one or the "
            "other")
        self.fused = fused
        self.jit_segments = jit_segments
        self.step_fn = step_fn
        self.fault_hooks = list(fault_hooks)
        self.boundary_hooks = list(boundary_hooks)
        self.store = store
        if store is not None and persist_every is None:
            persist_every = 1
        self.persist_every = persist_every
        self.semantics = semantics
        self.elastic_policy = elastic_policy
        self.step_factory = step_factory
        self.grow_at = grow_at
        self.elastic: Optional[ElasticController] = None
        if semantics in (Semantics.SHRINK, Semantics.BLANK):
            self.elastic = ElasticController(
                semantics, self.state.geom, policy=elastic_policy)
        self.straggler_monitor = straggler_monitor
        self.lane_clock = lane_clock
        self.scheme = XORPairScheme() if scheme is None else scheme
        self.async_segments = async_segments
        if async_segments:
            assert semantics in (Semantics.REBUILD, Semantics.ABORT), (
                "async double-buffered segments compose with REBUILD/ABORT "
                "only; elastic transitions re-mesh the world mid-run and "
                "would invalidate every in-flight speculation")
            assert straggler_monitor is None and grow_at is None and not fused
        # set by from_state: the resume boundary owes a hook/poll pass
        # before any segment runs (see _resume_boundary_pass)
        self._resumed = False
        self.speculations: List[SpeculationEvent] = []
        self._spec_counts: Dict[int, int] = {}
        self.events: List[RecoveryEvent] = []
        # run statistics
        self.segments_run = 0
        self.boundaries = 0
        self.poll_s = 0.0
        self.recover_s = 0.0

    @classmethod
    def from_state(cls, state: SweepState, comm, **kw) -> "SweepOrchestrator":
        """Resume from a persisted mid-sweep ``SweepState``
        (``repro_torch.ckpt.load_sweep_state`` or a diskless snapshot). The
        previous incarnation's event log is not carried over."""
        orch = cls(comm=comm, state=state, **kw)
        orch._resumed = True
        return orch

    # -- segments ----------------------------------------------------------

    def _stepped(self, state: SweepState, n_points: int) -> SweepState:
        if not self.jit_segments:
            return run_steps(self.comm, state, n_points)
        return compiled_segment(self.comm, n_points)(state)

    def _fused_segment(self, state: SweepState) -> SweepState:
        # a state resumed mid-panel first steps to the next leaf boundary
        # (fused segments start only there), then runs whole panels
        while state.cursor is not None and state.cursor[1] != PHASE_LEAF:
            state = self._stepped(state, 1)
        if state.cursor is None:
            return state
        if not self.jit_segments:
            return run_panel_fused(self.comm, state)
        return _fused_segment_runner(self.comm)(state)

    def _segment(self, state: SweepState) -> SweepState:
        if self.step_fn is not None:
            for _ in range(self.segment_points):
                if state.cursor is None:
                    break
                state = self.step_fn(state)
            return state
        if self.fused:
            return self._fused_segment(state)
        return self._stepped(state, self.segment_points)

    # -- the host loop -----------------------------------------------------

    def run(self):
        """Drive the sweep to completion; returns the ``FTSweepResult`` of
        ``ft_caqr_sweep`` (bit-identical to the failure-free sweep whatever
        the detector found, or ``UnrecoverableFailure``), or under
        SHRINK/BLANK an ``ElasticSweepResult``."""
        if self._resumed:
            self._resumed = False
            self._resume_boundary_pass()
        if self.async_segments:
            return self._run_async()
        boundary = 0
        while True:
            # re-read each iteration: a transition swaps in a new epoch's
            # geometry and comm
            geom = self.state.geom
            if self.state.cursor is not None:
                self.state = self._segment(self.state)
                self.segments_run += 1
            boundary += 1
            self.boundaries += 1
            # re-encode the parity slots from the boundary state before the
            # hooks and the detector can see this boundary's deaths
            self.state = self.scheme.refresh(self.comm, self.state)
            point = prev_sweep_point(self.state.cursor, geom.n_panels,
                                     geom.levels)
            for hook in self.fault_hooks:
                self.state = hook(self.comm, self.state)
            t0 = time.perf_counter()
            newly = list(self.detector.poll(self.comm, self.state))
            self.poll_s += time.perf_counter() - t0
            if newly:
                self._recover(newly, point)
            if (self.straggler_monitor is not None
                    and self.lane_clock is not None
                    and self.state.cursor is not None):
                self._check_stragglers(point)
            if self.elastic is not None and point == self.grow_at:
                self.elastic.request_grow()
            self._maybe_transition()
            for hook in self.boundary_hooks:
                hook(self)
            self._persist(boundary)
            if self.state.cursor is None and (
                    self.elastic is None or not self.elastic.pending):
                break
        if self.elastic is not None:
            return self.elastic.finish(self.comm, self.state, self.events)
        return self._result()

    def _result(self) -> FTSweepResult:
        R, factors, bundles = finalize(self.comm, self.state)
        return FTSweepResult(R=R, factors=factors, bundles=bundles,
                             events=self.events)

    def _persist(self, boundary: int) -> None:
        if self.store is not None and self.persist_every and (
                boundary % self.persist_every == 0
                or self.state.cursor is None):
            self.store.push(self.state)

    def _resume_boundary_pass(self) -> None:
        """Hook/poll pass at the resume boundary, before any segment runs.
        A death that struck while the sweep was suspended is recovered
        from the state as persisted: the parity slots are not re-encoded
        first, so under ``MDSScheme`` the joint decode uses the persisted
        ``state.code`` (wire format v2)."""
        if self.state.cursor is None:
            return
        geom = self.state.geom
        point = prev_sweep_point(self.state.cursor, geom.n_panels, geom.levels)
        if point is None:
            return  # resumed at the very first point: nothing completed yet
        for hook in self.fault_hooks:
            self.state = hook(self.comm, self.state)
        t0 = time.perf_counter()
        newly = list(self.detector.poll(self.comm, self.state))
        self.poll_s += time.perf_counter() - t0
        if newly:
            self._recover(newly, point)

    def _probe(self, state: SweepState):
        """Start a detector poll: the split ``probe`` when the detector has
        one, else a plain ``poll`` run now. Returns a callable that
        finishes it (blocking) and gives the newly dead lanes."""
        probe = getattr(self.detector, "probe", None)
        if probe is None:
            newly = list(self.detector.poll(self.comm, state))
            return lambda: newly
        handle = probe(self.comm, state)
        return lambda: list(self.detector.collect(self.comm, handle))

    def _run_async(self) -> FTSweepResult:
        """The double-buffered segment loop. The poll is the only step that
        waits for the device, so the loop puts the detector's probe of
        boundary N on the stream, issues segment N+1 from the boundary
        state, and only then collects the probe: the host issues the next
        segment while the card runs this one. The speculative segment
        writes only fresh tensors (no transition changes the state it is
        given) and is kept only when the boundary was quiet; a fault-hook
        change (object identity: a hook that does nothing returns the
        same state) or a detected death throws it away and re-issues from
        the recovered state, which is what the sync loop runs, so the
        results are bitwise those of the sync loop."""
        boundary = 0
        cur = self.state
        if cur.cursor is not None:
            cur = self._segment(cur)
            self.segments_run += 1
        while True:
            geom = cur.geom
            cur = self.scheme.refresh(self.comm, cur)
            point = prev_sweep_point(cur.cursor, geom.n_panels, geom.levels)
            pre_hooks = cur
            for hook in self.fault_hooks:
                cur = hook(self.comm, cur)
            t0 = time.perf_counter()
            finish_poll = self._probe(cur)
            self.poll_s += time.perf_counter() - t0
            spec = None
            if cur is pre_hooks and cur.cursor is not None:
                # quiet so far: issue the next segment ahead of the
                # (blocking) collect, the double buffer
                spec = self._segment(cur)
            t0 = time.perf_counter()
            newly = finish_poll()
            self.poll_s += time.perf_counter() - t0
            boundary += 1
            self.boundaries += 1
            self.state = cur
            if newly:
                spec = None  # issued from a state the recovery rewrites
                self._recover(newly, point)
            for hook in self.boundary_hooks:
                hook(self)
            self._persist(boundary)
            if self.state.cursor is None:
                break
            if spec is not None and self.state is cur:
                cur = spec
            else:
                # a hook or a recovery rewrote the state: re-issue from the
                # real boundary
                cur = self._segment(self.state)
            self.segments_run += 1
        return self._result()

    # -- elastic transitions -----------------------------------------------

    def _maybe_transition(self) -> None:
        """Apply a pending SHRINK/BLANK/grow at a panel boundary and swap
        in the new world's comm, runner and detector arming."""
        while self.elastic is not None and \
                self.elastic.ready(self.state.cursor):
            new_comm, new_state = self.elastic.transition(
                self.comm, self.state)
            self.state = new_state
            if new_comm is None:
                # the closing epoch finished the factorization; leftover
                # requests are bookkeeping only
                continue
            break
        else:
            return
        self.comm = new_comm
        if self.step_fn is not None:
            assert self.step_factory is not None, (
                "an elastic transition under step_fn= needs step_factory= "
                "to build the runner of the new world")
            self.step_fn = self.step_factory(new_comm.axis_size())
        reset = getattr(self.detector, "reset", None)
        if reset is not None:
            reset()  # the new world numbers its lanes afresh
        if self.straggler_monitor is not None:
            self.straggler_monitor.ewma.clear()
            for k in self.straggler_monitor.flags:
                self.straggler_monitor.flags[k] = 0

    # -- stragglers --------------------------------------------------------

    def _check_stragglers(self, point) -> None:
        times = self.lane_clock(self.comm, self.state)
        flagged = self.straggler_monitor.report(times)
        cfg = self.straggler_monitor.cfg
        # only live lanes of the current world can be acted on
        flagged = [
            l for l in flagged
            if l < self.comm.axis_size() and (
                self.elastic is None or self.elastic.world.live[l])]
        for lane in flagged:
            if cfg.policy is StragglerPolicy.SPECULATE:
                self._speculate(lane, point)
                self.straggler_monitor.flags[lane] = 0
                n = self._spec_counts.get(lane, 0) + 1
                self._spec_counts[lane] = n
                if cfg.escalate_after is not None and n >= cfg.escalate_after:
                    self._evict(lane, point)
            elif cfg.policy is StragglerPolicy.EVICT:
                self._evict(lane, point)
            # REBALANCE/IGNORE have no mid-sweep action

    def _speculate(self, lane: int, point) -> None:
        """Speculative buddy recompute of a straggler's sweep point: the
        REBUILD arithmetic for ``lane`` on a copy, its slices compared bit
        for bit with the lane's own, and the rebuilt copy kept (the first
        result wins; a mismatch means the lane was corrupt, not slow)."""
        struck = obliterate_state(self.comm, self.state, lane)
        spec, reads = rebuild_state(self.comm, struck, lane, point, {lane})
        axes = flat_arrays(state_lane_axes(self.state))
        own, new = flat_arrays(self.state), flat_arrays(spec)
        matched = all(
            torch.equal(self.comm.lane_slice(own[k], lane, ax),
                        self.comm.lane_slice(new[k], lane, ax))
            for k, ax in axes.items() if ax >= 0)
        self.state = spec
        self.speculations.append(SpeculationEvent(
            point=tuple(point), lane=lane, matched=matched, reads=reads))

    def _evict(self, lane: int, point) -> None:
        """Persistent straggler: treat it as failed, heal it from its
        buddies, and hand it to the elastic controller as a SHRINK death."""
        if self.elastic is None:
            self.elastic = ElasticController(
                Semantics.SHRINK, self.state.geom, policy=self.elastic_policy)
        self.state = obliterate_state(self.comm, self.state, lane)
        self._heal([lane], point)
        self.elastic.note_deaths([lane])
        self.straggler_monitor.ewma.pop(lane, None)
        self.straggler_monitor.flags[lane] = 0
        self._spec_counts.pop(lane, None)

    # -- recovery ----------------------------------------------------------

    def _recover(self, newly: List[int], point) -> None:
        assert point is not None, "death detected before any sweep point ran"
        if self.semantics is Semantics.ABORT:
            raise LaneFailure(newly[0], point)
        # SHRINK/BLANK heal exactly like REBUILD, then note the death for
        # the boundary transition
        self._heal(newly, point)
        if self.elastic is not None and self.semantics in (
                Semantics.SHRINK, Semantics.BLANK):
            self.elastic.note_deaths(newly)

    def _heal(self, newly: List[int], point) -> None:
        dead = set(newly)

        def on_recovered(lane: int) -> None:
            dead.discard(lane)
            revive = getattr(self.detector, "revive", None)
            if revive is not None:
                revive(lane)

        # the scheduled driver's strike-then-rebuild protocol, shared code
        self.state, events = recover_lanes(
            self.comm, self.state, newly, point, dead,
            sync=_block_on_state, on_recovered=on_recovered,
            scheme=self.scheme)
        self.recover_s += sum(e.elapsed_s for e in events)
        self.events.extend(events)


def ft_caqr_sweep_online(
    A0,
    comm,
    panel_width: int,
    detector: Optional[OnlineDetector] = None,
    **kw,
):
    """One-call form of the online path, ``SweepOrchestrator(...).run()``:
    the result of ``ft_caqr_sweep``, with failures discovered by
    ``detector`` at runtime instead of scripted.

    >>> import numpy as np, torch
    >>> from repro_torch.core import SimComm
    >>> from repro_torch.ft import (ScriptedKiller, ft_caqr_sweep,
    ...                             ft_caqr_sweep_online, sweep_point)
    >>> A = torch.from_numpy(np.random.default_rng(0).standard_normal(
    ...     (2, 4, 4)).astype(np.float32))
    >>> kill = ScriptedKiller({sweep_point(0, "trailing", 0): [1]})
    >>> out = ft_caqr_sweep_online(A, SimComm(2), 4, fault_hooks=[kill])
    >>> bool(torch.equal(out.R, ft_caqr_sweep(A, SimComm(2), 4).R))
    True
    >>> [(e.point, e.lane) for e in out.events]
    [((0, 'trailing', 0), 1)]
    """
    return SweepOrchestrator(A0, comm, panel_width, detector, **kw).run()
