"""Straggler detection and mitigation (port of ``src/repro/ft/stragglers.py``;
numpy only, a copy: the port imports nothing of the JAX package).

At pod scale a slow chip/host stretches every synchronous step. The monitor
keeps an EWMA of per-lane step-report times; lanes persistently slower than
``threshold`` x the median are flagged. Policies:

  * REBALANCE — shrink the straggler's microbatch share and grow the
    fastest lanes' (kept normalized); the returned shares feed the data
    pipeline's per-lane row assignment.
  * EVICT     — treat a persistent straggler as failed: hand it to the
    fault-tolerance supervisor (SHRINK/REBUILD semantics do the rest).
  * SPECULATE — mid-sweep only (the orchestrator's segment loop): rather
    than blocking the boundary on the slow lane, recompute its sweep
    point speculatively from its XOR buddy with the proven REBUILD
    arithmetic, bitwise-check the two results, and let the first one win.
    A ``SpeculationEvent`` records each race; ``escalate_after`` races on
    the same lane escalates to EVICT (which under the elastic
    orchestrator becomes a SHRINK transition — ``repro_torch.ft.elastic``).

In one process the lane times are simulated by the tests (a
``lane_clock``); the policy logic is what a deployment runs on real step
reports.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, NamedTuple, Optional

import numpy as np


class StragglerPolicy(enum.Enum):
    REBALANCE = "rebalance"
    EVICT = "evict"
    IGNORE = "ignore"
    SPECULATE = "speculate"


class SpeculationEvent(NamedTuple):
    """One speculative buddy recompute of a straggler's sweep point:
    where it ran, which lane raced, whether the speculative result
    bitwise-matched the straggler's own (it must, when the lane is merely
    slow — a mismatch means corruption and the rebuilt copy wins), and
    the buddy reads the recompute cost."""

    point: tuple
    lane: int
    matched: bool
    reads: Dict[str, int]


@dataclasses.dataclass
class StragglerConfig:
    threshold: float = 1.5       # x median EWMA to flag
    patience: int = 3            # consecutive flagged steps before acting
    ewma: float = 0.5
    min_share: float = 0.25      # floor on a rebalanced lane's share
    policy: StragglerPolicy = StragglerPolicy.REBALANCE
    escalate_after: Optional[int] = None  # SPECULATE races before EVICT


class StragglerMonitor:
    def __init__(self, n_lanes: int, cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg or StragglerConfig()
        self.n = n_lanes
        self.ewma: Dict[int, float] = {}
        self.flags: Dict[int, int] = {i: 0 for i in range(n_lanes)}
        self.shares: Dict[int, float] = {i: 1.0 for i in range(n_lanes)}

    def report(self, lane_times: Dict[int, float]) -> List[int]:
        """Feed one step's per-lane times; returns lanes to act on."""
        a = self.cfg.ewma
        for lane, t in lane_times.items():
            prev = self.ewma.get(lane, t)
            self.ewma[lane] = a * t + (1 - a) * prev
        med = float(np.median(list(self.ewma.values())))
        actions = []
        for lane, e in self.ewma.items():
            if e > self.cfg.threshold * med:
                self.flags[lane] += 1
                if self.flags[lane] >= self.cfg.patience:
                    actions.append(lane)
            else:
                self.flags[lane] = 0
        return actions

    def rebalance(self, straggler: int) -> Dict[int, float]:
        """Shift batch share from the straggler to the others, floor-limited.
        Shares stay normalized to sum to n (1.0 == a fair share)."""
        med = float(np.median(list(self.ewma.values())))
        slow = self.ewma[straggler]
        target = max(self.cfg.min_share, med / slow)
        delta = self.shares[straggler] - target
        self.shares[straggler] = target
        others = [l for l in self.shares if l != straggler]
        for l in others:
            self.shares[l] += delta / len(others)
        self.flags[straggler] = 0
        return dict(self.shares)

    def lane_rows(self, global_batch: int) -> Dict[int, int]:
        """Integer per-lane row counts implied by the current shares."""
        per = global_batch / self.n
        rows = {l: int(round(per * s)) for l, s in self.shares.items()}
        # fix rounding drift on the fastest lane
        drift = global_batch - sum(rows.values())
        fastest = min(self.ewma or {0: 0.0}, key=lambda l: self.ewma.get(l, 0.0))
        rows[fastest] += drift
        return rows
