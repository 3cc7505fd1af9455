"""Runtime failure detection for the online sweep (port of
``src/repro/ft/online/detect.py``).

No schedule: the orchestrator polls a detector at every segment boundary,
and deaths are *discovered*. The mask-based death (``comm.poison``
NaN-floods everything the lane holds) makes a death observable in-band: a
designated *sentinel slot* per lane goes NaN.

Detectors (the ``OnlineDetector`` protocol):

* ``NaNSentinelDetector`` probes the sentinel slots between segments
  (element ``[0, 0]`` of each lane's block-row slice, plus the in-flight
  R / C' heads): P floats cross to the host per poll; ``deep`` scans every
  float leaf. It also has the split non-blocking form: ``probe`` puts the
  sentinel sum on the current stream, starts a non-blocking copy into a
  pinned host buffer and records a CUDA event; ``collect`` waits on that
  event. The async orchestrator issues the next segment in between.
* ``FailStopDetector``: the harness ``declare``-s a death and the detector
  reports it after ``report_delay`` polls.
* ``DelayedDetector`` wraps a detector and suppresses each lane's first
  ``miss`` positive reports (a false negative).

Fault injectors (the cause, not the detection) are boundary hooks the
orchestrator runs before each poll: ``ScriptedKiller`` (die at a chosen
sweep point) and ``WallClockKiller`` (die at the first boundary past a
wall-clock deadline). Both leave discovery to the detector.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterable, List, Optional, Protocol, Set, Tuple

import numpy as np
import torch

from repro_torch.ft.failures import prev_sweep_point
from repro_torch.ft.online.state import SweepState, flat_arrays, state_lane_axes

_SENTINEL_FIELDS = ("A", "window", "R_leaf", "R_carry", "C_prime")


class OnlineDetector(Protocol):
    """Runtime failure detector: polled at every segment boundary; returns
    the lanes it believes died since the last poll (never lanes it already
    reported: the orchestrator rebuilds them at once, so a repeat report
    would re-kill a healthy respawn)."""

    def poll(self, comm, state: SweepState) -> List[int]:  # pragma: no cover
        ...

    def revive(self, lane: int) -> None:  # pragma: no cover
        """Optional: a completed REBUILD re-arms the detector for
        ``lane`` at once, so back-to-back deaths at consecutive boundaries
        are still seen."""


def _sentinel_sum(comm, state: SweepState) -> torch.Tensor:
    """One float per lane, on the state's device: the sum of the lane's
    sentinel slots (NaN iff any is NaN): the block-row head plus whatever
    in-flight per-lane artifact heads exist at the cursor."""
    # x[:, 0, ..., 0] is x.reshape(P, -1)[:, 0] without copying a strided
    # window
    probes = [x[(slice(None),) + (0,) * (x.dim() - 1)] for x in
              (getattr(state, f) for f in _SENTINEL_FIELDS) if x is not None]
    return torch.sum(torch.stack(probes), dim=0)


def _deep_nan_lanes(comm, state: SweepState) -> Set[int]:
    """Full scan: any NaN per lane over every float leaf (lane axis from
    ``state_lane_axes``), with one transfer to the host."""
    P = comm.axis_size()
    axes = flat_arrays(state_lane_axes(state))
    hit = None
    for key, x in flat_arrays(state).items():
        ax = axes[key]
        if ax < 0 or not x.is_floating_point():
            continue
        per_lane = torch.isnan(torch.movedim(x, ax, 0).reshape(P, -1)).any(1)
        hit = per_lane if hit is None else hit | per_lane
    if hit is None:
        return set()
    return {int(i) for i in np.flatnonzero(hit.cpu().numpy())}


class NaNSentinelDetector:
    """Sentinel-slot NaN probe over the lane-batched state. Reports each
    lane once per death; after the orchestrator rebuilds it the sentinels
    are finite again and the lane re-arms. A workload whose data holds NaN
    would be a false positive; the sweep on finite input never makes NaN
    in a live lane."""

    def __init__(self, deep: bool = False):
        self.deep = deep
        self._reported: Set[int] = set()

    def poll(self, comm, state: SweepState) -> List[int]:
        return self.collect(comm, self.probe(comm, state))

    # -- the split, non-blocking poll (the async orchestrator's) ------------

    def probe(self, comm, state: SweepState) -> Any:
        """Put the sentinel sum on the current stream without waiting for
        it and return a handle for :meth:`collect`. On the GPU the sum is
        copied (non-blocking) into a pinned host buffer and a CUDA event is
        recorded after the copy; the host is free until ``collect``.
        ``deep`` mode has no split form: its handle defers the scan."""
        if self.deep:
            return ("deep", state)
        sent = _sentinel_sum(comm, state)
        if not sent.is_cuda:
            return ("sent", (sent, None))
        host = torch.empty(sent.shape, dtype=sent.dtype, pin_memory=True)
        host.copy_(sent, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return ("sent", (host, done))

    def collect(self, comm, handle: Any) -> List[int]:
        """The blocking half of the split poll: wait for a :meth:`probe`
        handle and return the newly dead lanes (reported once per death;
        a lane re-arms after ``revive`` or once its sentinels are
        finite)."""
        kind, payload = handle
        if kind == "deep":
            hit = _deep_nan_lanes(comm, payload)
        else:
            values, done = payload
            if done is not None:
                done.synchronize()
            hit = {int(i) for i in np.flatnonzero(np.isnan(values.numpy()))}
        newly = sorted(hit - self._reported)
        self._reported = hit
        return newly

    def revive(self, lane: int) -> None:
        self._reported.discard(lane)

    def reset(self) -> None:
        """Re-arm every sentinel (after an elastic transition the lane
        numbering changed)."""
        self._reported.clear()


class FailStopDetector:
    """Injectable fail-stop oracle for tests: the harness declares deaths,
    the detector surfaces each ``report_delay`` polls later (0 = the next
    boundary)."""

    def __init__(self, report_delay: int = 0):
        self.report_delay = report_delay
        self._pending: Dict[int, int] = {}  # lane -> polls still to wait

    def declare(self, lane: int) -> None:
        self._pending.setdefault(lane, self.report_delay)

    def poll(self, comm, state: SweepState) -> List[int]:
        ready = sorted(l for l, d in self._pending.items() if d <= 0)
        for l in list(self._pending):
            if l in ready:
                del self._pending[l]
            else:
                self._pending[l] -= 1
        return ready

    def revive(self, lane: int) -> None:
        pass  # reports are one-shot; a new death needs a new declare()


class DelayedDetector:
    """Suppress each lane's first ``miss`` positive reports from ``inner``
    (a false negative over a real probe). The suppressed death surfaces at
    a later boundary, since the NaN sentinels are still NaN."""

    def __init__(self, inner: OnlineDetector, miss: int = 1):
        self.inner = inner
        self.miss = miss
        self._suppressed: Dict[int, int] = {}

    def poll(self, comm, state: SweepState) -> List[int]:
        out = []
        for lane in self.inner.poll(comm, state):
            seen = self._suppressed.get(lane, 0)
            if seen < self.miss:
                self._suppressed[lane] = seen + 1
                # re-arm the inner detector so it re-reports next poll
                rearm = getattr(self.inner, "_reported", None)
                if rearm is not None:
                    rearm.discard(lane)
            else:
                self._suppressed.pop(lane, None)
                out.append(lane)
        return out

    def revive(self, lane: int) -> None:
        self._suppressed.pop(lane, None)
        revive = getattr(self.inner, "revive", None)
        if revive is not None:
            revive(lane)


# -- fault injectors (boundary hooks; the cause, not the detection) ----------


def _just_completed(state: SweepState) -> Optional[Tuple[int, str, int]]:
    return prev_sweep_point(state.cursor, state.geom.n_panels,
                            state.geom.levels)


class ScriptedKiller:
    """Boundary hook: poison ``lanes`` when the just-completed sweep point
    is a key of ``events`` (each event fires once). Discovery is left to
    the detector."""

    def __init__(self, events: Dict[Tuple[int, str, int], Iterable[int]]):
        self.events = {k: list(v) for k, v in events.items()}
        self._fired: Set[Tuple[Tuple[int, str, int], int]] = set()

    def __call__(self, comm, state: SweepState) -> SweepState:
        from repro_torch.ft.driver import obliterate_state

        point = _just_completed(state)
        for lane in self.events.get(point, []):
            if (point, lane) not in self._fired:
                self._fired.add((point, lane))
                state = obliterate_state(comm, state, lane)
        return state


class WallClockKiller:
    """Boundary hook: poison ``lane`` at the first segment boundary more
    than ``after_s`` seconds after the hook's first call; ``struck_at``
    records where. ``clock`` is injectable (a fake clock in tests)."""

    def __init__(self, after_s: float, lane: int, clock=time.monotonic):
        self.after_s = after_s
        self.lane = lane
        self.clock = clock
        self._t0: Optional[float] = None
        self.struck_at: Optional[Tuple[int, str, int]] = None

    def __call__(self, comm, state: SweepState) -> SweepState:
        from repro_torch.ft.driver import obliterate_state

        now = self.clock()
        if self._t0 is None:
            self._t0 = now
        if self.struck_at is None and now - self._t0 >= self.after_s \
                and state.cursor is not None:
            self.struck_at = _just_completed(state)
            if self.struck_at is not None:  # not before the first point
                state = obliterate_state(comm, state, self.lane)
        return state
