"""Failure injection and the sweep-point cursor algebra (port of
``src/repro/ft/failures.py``; pure Python, copied).

``FailureSchedule`` scripts lane deaths at given steps; ``Detector`` models
ULFM semantics: an operation touching a failed lane raises
``LaneFailure``, operations not involving it proceed unknowingly (paper
§II last paragraph). The sweep-point address arithmetic
(``next_sweep_point`` / ``prev_sweep_point``) is the cursor algebra of the
reified state machine (``repro_torch.ft.online.state``).

The FT-CAQR sweep driver (``repro_torch.ft.driver``) keys its schedule by
``sweep_point(panel, phase, level)`` tuples, so a lane can be killed at
any interruptible point of the factorization:

* ``("leaf")``      — after the panel's local leaf QR, before the first
                      butterfly level;
* ``("tsqr", s)``    — after TSQR butterfly level ``s`` completes;
* ``("trailing", s)``— after trailing-combine level ``s`` completes.

A death *during* a level is detected by the survivors at that level's
collective and leaves them at the previous level's state, so the
"after level s, before level s+1" checkpoints cover the full state space of
the paper's failure model (one address per distinct recoverable state).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, List, Optional, Set, Tuple

# Interruptible phases of one panel of the CAQR sweep, in execution order.
PHASE_LEAF = "leaf"
PHASE_TSQR = "tsqr"
PHASE_TRAILING = "trailing"
SWEEP_PHASES = (PHASE_LEAF, PHASE_TSQR, PHASE_TRAILING)


def sweep_point(panel: int, phase: str, level: int = 0) -> Tuple[int, str, int]:
    """Address of an interruptible point in the CAQR sweep (a schedule key).

    The paper's failure model (§II) allows a process to die at any point of
    the factorization; the distinct *recoverable states* are the boundaries
    between tree levels (§III-B for TSQR, §III-C for the trailing update),
    which is exactly this address space. ``level`` is the just-completed
    tree level (ignored for ``leaf``).

    >>> sweep_point(2, "tsqr", 1)
    (2, 'tsqr', 1)
    >>> sweep_point(0, "leaf")
    (0, 'leaf', 0)
    """
    assert phase in SWEEP_PHASES, phase
    return (panel, phase, 0 if phase == PHASE_LEAF else level)


def iter_sweep_points(n_panels: int, levels: int):
    """All interruptible points of an ``n_panels``-panel sweep over a
    ``levels``-level tree, in driver execution order — the kill-matrix
    enumeration (tests, chip_smoke.py). ``n_panels`` comes from the sweep's
    ``caqr.sweep_geometry`` (``ceil(min(m, n) / b)``), so the enumeration
    covers ragged and wide geometries exactly as the driver walks them.

    >>> list(iter_sweep_points(n_panels=1, levels=2))  # 1 panel, P=4 tree
    [(0, 'leaf', 0), (0, 'tsqr', 0), (0, 'tsqr', 1), (0, 'trailing', 0), (0, 'trailing', 1)]
    """
    for k in range(n_panels):
        yield sweep_point(k, PHASE_LEAF)
        for s in range(levels):
            yield sweep_point(k, PHASE_TSQR, s)
        for s in range(levels):
            yield sweep_point(k, PHASE_TRAILING, s)


def next_sweep_point(
    point: Tuple[int, str, int], n_panels: int, levels: int
) -> Optional[Tuple[int, str, int]]:
    """Successor of ``point`` in driver execution order, ``None`` after the
    last point — the cursor advance of the reified sweep state machine
    (``repro_torch.ft.online.state``).

    >>> next_sweep_point((0, "leaf", 0), 2, 2)
    (0, 'tsqr', 0)
    >>> next_sweep_point((0, "trailing", 1), 2, 2)
    (1, 'leaf', 0)
    >>> next_sweep_point((1, "trailing", 1), 2, 2) is None
    True
    """
    k, phase, s = point
    if phase == PHASE_LEAF:
        return sweep_point(k, PHASE_TSQR, 0)
    if phase == PHASE_TSQR:
        if s + 1 < levels:
            return sweep_point(k, PHASE_TSQR, s + 1)
        return sweep_point(k, PHASE_TRAILING, 0)
    if s + 1 < levels:
        return sweep_point(k, PHASE_TRAILING, s + 1)
    if k + 1 < n_panels:
        return sweep_point(k + 1, PHASE_LEAF)
    return None


def prev_sweep_point(
    point: Optional[Tuple[int, str, int]], n_panels: int, levels: int
) -> Optional[Tuple[int, str, int]]:
    """Predecessor of ``point`` (``None`` = past-the-end, i.e. the last
    point); ``None`` for the very first point. The orchestrator uses this to
    name the just-completed recoverable boundary a runtime-detected death is
    attributed to.

    >>> prev_sweep_point((0, "tsqr", 0), 2, 2)
    (0, 'leaf', 0)
    >>> prev_sweep_point(None, 2, 2)
    (1, 'trailing', 1)
    >>> prev_sweep_point((0, "leaf", 0), 2, 2) is None
    True
    """
    if point is None:
        return sweep_point(n_panels - 1, PHASE_TRAILING, max(levels - 1, 0))
    k, phase, s = point
    if phase == PHASE_LEAF:
        if k == 0:
            return None
        return sweep_point(k - 1, PHASE_TRAILING, max(levels - 1, 0))
    if phase == PHASE_TSQR:
        if s == 0:
            return sweep_point(k, PHASE_LEAF)
        return sweep_point(k, PHASE_TSQR, s - 1)
    if s == 0:
        return sweep_point(k, PHASE_TSQR, max(levels - 1, 0))
    return sweep_point(k, PHASE_TRAILING, s - 1)


class LaneFailure(RuntimeError):
    def __init__(self, lane: int, step: Hashable):
        super().__init__(f"lane {lane} failed at step {step}")
        self.lane = lane
        self.step = step


class UnrecoverableFailure(RuntimeError):
    """Raised when a REBUILD cannot proceed: the single-source buddy that
    holds the needed artifact is itself dead (e.g. both members of a pair
    were killed at the same point)."""


@dataclasses.dataclass
class FailureSchedule:
    """{step: [lanes that die at the start of that step]}.

    Keys are ``sweep_point(...)`` tuples for the CAQR sweep driver (any
    hashable step works). The schedule is static Python data that every
    lane sees, the analogue of the paper's §II assumption that survivors
    agree on who failed and where.

    >>> s = FailureSchedule(events={sweep_point(1, "tsqr", 0): [2, 3]})
    >>> s.lanes_failing_at(sweep_point(1, "tsqr", 0))
    [2, 3]
    >>> s.lanes_failing_at(sweep_point(0, "leaf"))
    []
    """

    events: Dict[Hashable, List[int]] = dataclasses.field(default_factory=dict)

    def lanes_failing_at(self, step: Hashable) -> List[int]:
        return self.events.get(step, [])


class Detector:
    """ULFM-style failure detection (paper §II): deaths scheduled at a step
    fire when the step begins; an operation that *touches* a failed lane
    raises ``LaneFailure``, operations not involving it proceed unknowingly.

    >>> d = Detector(4, FailureSchedule(events={7: [1]}))
    >>> d.begin_step(7)          # the scheduled death fires (once)
    [1]
    >>> d.begin_step(7)          # a replay does not re-kill the respawn
    []
    >>> d.revive(1); sorted(d.dead)
    []
    """

    def __init__(self, n_lanes: int, schedule: Optional[FailureSchedule] = None):
        self.n = n_lanes
        self.schedule = schedule or FailureSchedule()
        self.dead: Set[int] = set()
        self.fired: Set[Tuple[Hashable, int]] = set()

    def begin_step(self, step: Hashable) -> List[int]:
        """Kill scheduled lanes; return the newly dead (detection event).
        Each scheduled (step, lane) event fires exactly once — a REBUILD
        replay passing the same step does not re-kill the respawned lane."""
        newly = []
        for l in self.schedule.lanes_failing_at(step):
            if l not in self.dead and (step, l) not in self.fired:
                newly.append(l)
                self.fired.add((step, l))
        self.dead.update(newly)
        return newly

    def check(self, lanes: Tuple[int, ...], step: Hashable) -> None:
        """An operation involving these lanes: raises on the first dead one."""
        for l in lanes:
            if l in self.dead:
                raise LaneFailure(l, step)

    def revive(self, lane: int) -> None:
        self.dead.discard(lane)
