"""The FT-QR engine behind the FT training runtime (port of
``src/repro/train/ftrun/engine.py``).

Each ``orthonormalize`` call is a full windowed FT-CAQR sweep driven by
the port's online ``SweepOrchestrator`` over ``SimComm(n_lanes)`` (the
lane axis is the leading tensor axis; on one card the production layout):
segment boundaries, runtime failure detection, REBUILD healing (or the
MDS joint decode), optionally async double-buffered segments. Its stepped
segments run K1-K4 on a CUDA tensor. A lane killed inside an optimizer
step is healed inside that step, and the returned Q is bit-identical to
the failure-free sweep's.

Q recovery: the sweep gives the replicated R; the engine forms
``Q = A R^{-1}`` with one triangular solve (``torch.linalg.solve_
triangular``; the JAX package also solves it outside any kernel). R is
bit-reproducible under failures, so Q is too.

Suspension: a boundary hook may raise :class:`SuspendSweep` carrying the
boundary-consistent state; the runtime persists it
(``repro_torch.ckpt.sweep``, wire v2) and a later process resumes the
sweep through the orchestrator's ``from_state``.

With ``mesh=`` (a one-axis lane mesh, ``repro_torch.launch.spmd_qr.
make_lane_mesh``) every point runs over the mesh's rank processes, one
lane a rank: each sweep's orchestrator gets a ``SpmdSweepStep`` as its
``step_fn`` (the reference's shard_map segment backend), which the engine
closes when the sweep ends. The fused panel does not combine with a
runner, so K5/K6 are off that path, as in the reference.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.comm import SimComm
from repro_torch.ft.online.detect import NaNSentinelDetector
from repro_torch.ft.online.orchestrator import SweepOrchestrator
from repro_torch.ft.online.state import SweepState
from repro_torch.ft.semantics import Semantics


class SuspendSweep(Exception):
    """Raised by an engine boundary hook to suspend the in-flight sweep;
    carries the boundary-consistent ``SweepState``."""

    def __init__(self, state: SweepState):
        super().__init__("sweep suspended at a segment boundary")
        self.state = state


class SuspendAfter:
    """Boundary hook: raise :class:`SuspendSweep` once ``n`` cumulative
    segment boundaries (across all sweeps of the engine) have run."""

    def __init__(self, n: int):
        assert n > 0
        self.n = n
        self.seen = 0

    def __call__(self, orch: SweepOrchestrator) -> None:
        self.seen += 1
        if self.seen >= self.n and orch.state.cursor is not None:
            raise SuspendSweep(orch.state)


def _q_from_r(A: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    # Q = A R^{-1}: the right triangular solve X R = A, no inverse
    return torch.linalg.solve_triangular(R, A, upper=True, left=False)


class QREngine:
    """Factorization service for optimizer-internal FT-CAQR sweeps.

    ``n_lanes`` (a power of two), ``panel_width`` (clamped per call to the
    matrix's column count), ``scheme`` (e.g. ``MDSScheme(f)``),
    ``semantics``, ``async_segments``, ``detector_factory`` (a fresh
    detector per sweep), ``fault_hooks``, ``boundary_hooks``, ``store`` and
    ``persist_every`` go to every sweep's ``SweepOrchestrator``; hooks are
    shared across sweeps. The sweep runs on the matrix's device.

    ``mesh`` (optional) runs the points over its ranks; its lane count
    must equal ``n_lanes``.

    Stats (cumulative): ``sweeps``, ``boundaries``, ``segments``,
    ``poll_s``, ``sweep_s``, ``recover_s``, and ``events``, every sweep's
    ``RecoveryEvent`` ledger in order; with a mesh also ``rank_reports``
    (each rank's ``RankReport`` summed over the sweeps) and ``step_stats``
    (the runners' accounts summed: points, seconds, bytes shipped and
    joined).
    """

    def __init__(
        self,
        n_lanes: int = 4,
        panel_width: int = 16,
        mesh=None,
        axis_name: str = "qr",
        scheme=None,
        semantics: Semantics = Semantics.REBUILD,
        async_segments: bool = False,
        detector_factory: Callable[[], object] = NaNSentinelDetector,
        fault_hooks: Sequence = (),
        boundary_hooks: Sequence = (),
        store=None,
        persist_every: Optional[int] = None,
    ):
        assert n_lanes & (n_lanes - 1) == 0, "lanes must be a power of two"
        if mesh is not None:
            (mesh_lanes,) = mesh.devices.shape
            assert mesh_lanes == n_lanes, (mesh_lanes, n_lanes)
            assert mesh.axis_names == (axis_name,), (mesh.axis_names, axis_name)
        self.mesh = mesh
        self.n_lanes = n_lanes
        self.panel_width = panel_width
        self.comm = SimComm(n_lanes)
        self.scheme = scheme
        self.semantics = semantics
        self.async_segments = async_segments
        self.detector_factory = detector_factory
        self.fault_hooks = list(fault_hooks)
        self.boundary_hooks = list(boundary_hooks)
        self.store = store
        self.persist_every = persist_every
        self.sweeps = 0
        self.boundaries = 0
        self.segments = 0
        self.poll_s = 0.0
        self.sweep_s = 0.0
        self.recover_s = 0.0
        self.events: List = []
        self.rank_reports: List = []
        self.step_stats: Dict[str, float] = {}

    def _runner(self):
        if self.mesh is None:
            return None
        from repro_torch.launch.spmd_qr import SpmdSweepStep

        return SpmdSweepStep(self.mesh.ranks(self.n_lanes), self.n_lanes)

    def _close_runner(self, runner) -> None:
        from repro_torch.launch.spmd_qr import _add_reports

        runner.close()
        self.rank_reports = _add_reports(self.rank_reports, runner.reports)
        for k, v in runner.stats().items():
            if k not in ("n_slots", "deltas"):
                self.step_stats[k] = self.step_stats.get(k, 0) + v

    def _orchestrator(self, A0, panel_width: int,
                      resume_state: Optional[SweepState], runner=None):
        kw = dict(
            detector=self.detector_factory(),
            step_fn=runner,
            fault_hooks=self.fault_hooks,
            boundary_hooks=self.boundary_hooks,
            semantics=self.semantics,
            scheme=self.scheme,
            async_segments=self.async_segments,
            store=self.store,
            persist_every=self.persist_every,
        )
        if resume_state is not None:
            return SweepOrchestrator.from_state(resume_state, self.comm, **kw)
        return SweepOrchestrator(A0, self.comm, panel_width, **kw)

    def factorize(self, M: torch.Tensor,
                  resume_state: Optional[SweepState] = None) -> torch.Tensor:
        """FT-CAQR sweep of tall-or-square ``M (m, n)``; returns the
        replicated ``(n, n)`` R. ``resume_state`` continues a suspended
        sweep (``M`` then only gives the shape)."""
        m, n = M.shape
        assert m >= n, "factorize wants tall input; use orthonormalize"
        P = self.n_lanes
        pad = (-m) % P
        Ap = M if pad == 0 else torch.cat([M, M.new_zeros((pad, n))], dim=0)
        A0 = Ap.reshape(P, (m + pad) // P, n).contiguous()
        runner = self._runner()
        orch = self._orchestrator(A0, min(self.panel_width, n), resume_state,
                                  runner)
        t0 = time.perf_counter()
        try:
            res = orch.run()
        finally:
            if runner is not None:
                self._close_runner(runner)
            self.sweeps += 1
            self.boundaries += orch.boundaries
            self.segments += orch.segments_run
            self.poll_s += orch.poll_s
            self.recover_s += orch.recover_s
            self.events.extend(orch.events)
            self.sweep_s += time.perf_counter() - t0
        return res.R[0]

    def orthonormalize(self, M: torch.Tensor,
                       resume_state: Optional[SweepState] = None) -> torch.Tensor:
        """Q with ``M``'s column space (row space when ``M`` is wide, the
        Muon convention of ``optim.caqr_muon._orth2d``), ``A R^{-1}`` from
        an FT-CAQR sweep's R. Raises :class:`SuspendSweep` through from a
        suspension hook."""
        m, n = M.shape
        tall = m >= n
        A = (M if tall else M.T).float()
        R = self.factorize(A, resume_state=resume_state)
        Q = _q_from_r(A, R)
        return Q if tall else Q.T
