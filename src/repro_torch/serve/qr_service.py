"""QR-as-a-service: continuous batching of FT-CAQR sweeps (port of
``src/repro/serve/qr_service.py``).

Many concurrent ragged-shape factorization and least-squares requests
multiplex through one resident segment runner of the sweep state machine:

* **buckets**: every request ``(m, n)`` is zero-padded into one of a few
  geometry buckets ``(m_loc, n_bucket)`` via ``block_row_layout`` and
  ``sweep_geometry``. Zero padding is exact, so the bucket changes no
  tenant's answer.
* **continuous batching at panel boundaries**: each :meth:`QRService.tick`
  advances every resident request by one panel (one segment of
  ``1 + 2*levels`` sweep points), then does the boundary work: detect and
  heal, retire, admit. New requests join only at this boundary, strictly
  FIFO; a finished request retires after ``ceil(k_req / b)`` panels, not
  the full bucket sweep, and frees its slot.
* **one resident runner**: every slot of every bucket dispatches through
  the process-wide ``repro_torch.ft.online.orchestrator.compiled_segment``
  runner, keyed by (comm kind, P, points), so one runner serves every
  bucket (:attr:`QRService.compiled_programs`). On the card each segment
  launches K1-K4 as the stepped sweep does.
* **mid-batch failures heal online**: a lane death (``kill_lane``) NaNs
  that lane's slice of every resident tenant's state. Each slot carries
  its own ``NaNSentinelDetector``; the boundary poll finds the death and
  ``recover_lanes`` heals each tenant from its XOR-buddy bundles (the
  single-source REBUILD), so every retired R stays bit-identical to a
  failure-free solo ``caqr_factorize`` of the same bucket-padded matrix.

Least squares rides the factorization: a request with a right-hand side is
admitted as the augmented ``[A | rhs]`` (the rhs columns sit beyond the
tenant's ``n_req``, so the panels that produce R update them to
``Q^T rhs``), and retirement back-solves ``R1 x = (Q^T rhs)[:k]`` on the
state's device, with the basic solution for wide problems.

``drain_batched`` is the static-batch path for offline bulk work: group
the queue by bucket and run each group through ``caqr_factorize_batched``.

Tenant states live on the service's device: CUDA unless the caller asks
for the CPU (``device="cpu"``, as the tests do); without CUDA the default
raises rather than falling back.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.caqr import (
    block_row_layout,
    caqr_factorize_batched,
    sweep_geometry,
)
from repro_torch.core.comm import SimComm
from repro_torch.ft.driver import (
    RecoveryEvent,
    _block_on_state,
    obliterate_state,
    recover_lanes,
)
from repro_torch.ft.failures import prev_sweep_point
from repro_torch.ft.online.detect import NaNSentinelDetector
from repro_torch.ft.online.orchestrator import compiled_segment
from repro_torch.ft.online.state import (
    SweepState,
    deposit_boundary,
    initial_sweep_state,
    panel_points,
)
from repro_torch.kernels.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class QRRequest:
    """One tenant's problem: factorize ``A`` (and, with ``rhs``, solve
    min ||Ax - rhs||). Host numpy, any ragged shape that fits a bucket."""

    rid: str
    A: np.ndarray                       # (m, n)
    rhs: Optional[np.ndarray] = None    # (m, nrhs)

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.A.shape)

    @property
    def k(self) -> int:
        return min(self.A.shape)


@dataclasses.dataclass
class QRResult:
    """A retired request: the tenant-shaped R slice (and x for lstsq
    requests) as host numpy arrays, plus the service telemetry."""

    rid: str
    R: np.ndarray                       # (k_req, n_req)
    x: Optional[np.ndarray]             # (n_req, nrhs) or None
    bucket: Tuple[int, int]
    panels: int
    ticks_resident: int
    latency_s: float                    # submit -> retire (incl. queue wait)
    events: List[RecoveryEvent]         # REBUILDs that hit this tenant


@dataclasses.dataclass
class _Slot:
    req: QRRequest
    bucket: Tuple[int, int]
    state: SweepState
    detector: NaNSentinelDetector
    panels_needed: int
    panels_done: int = 0
    admitted_tick: int = 0
    events: List[RecoveryEvent] = dataclasses.field(default_factory=list)


def _augmented(req: QRRequest) -> np.ndarray:
    return req.A if req.rhs is None else np.concatenate([req.A, req.rhs],
                                                        axis=1)


def _solve(req: QRRequest, R_full: torch.Tensor):
    """The tenant's ``(R, x)`` as host arrays from the R rows of its
    bucket sweep (``R_full``, on the device): R sliced to the tenant's
    shape and, for an lstsq request, the back-solve ``R1 x = (Q^T rhs)[:k]``
    in f32 (the basic solution for a wide problem)."""
    k_req, n_req = req.k, req.shape[1]
    R = R_full[:k_req, :n_req]
    x = None
    if req.rhs is not None:
        nrhs = req.rhs.shape[1]
        Qtb = R_full[:k_req, n_req:n_req + nrhs]
        x = torch.linalg.solve_triangular(R[:, :k_req], Qtb,
                                          upper=True).cpu().numpy()
        if n_req > k_req:
            x = np.concatenate(
                [x, np.zeros((n_req - k_req, nrhs), x.dtype)], axis=0)
    return R.cpu().numpy(), x


class QRService:
    """Multi-tenant continuous-batching front end over the online sweep.

    Parameters
    ----------
    comm:
        ``SimComm(P)``: the service drives host segments over the lane
        layout, as the orchestrator does.
    panel_width:
        b. One value service-wide: the segment size ``1 + 2*levels``
        depends only on P, so every bucket shares the one resident runner.
    buckets:
        The geometry menu, ``(m_loc, n)`` pairs (per-lane rows, working
        columns including any rhs columns). A request picks the first
        bucket that fits (sorted by area: the smallest sufficient bucket);
        submission raises if none fits.
    max_slots:
        Resident-batch capacity. Requests beyond it queue and are admitted
        as slots free up, strictly FIFO.
    device:
        Where tenant states live: CUDA by default (raises without a GPU),
        ``"cpu"`` to run the plain path on purpose.
    """

    def __init__(self, comm, panel_width: int = 4,
                 buckets: Sequence[Tuple[int, int]] = ((8, 12),),
                 max_slots: int = 8, device="cuda"):
        assert isinstance(comm, SimComm), (
            "QRService drives host segments over the SimComm layout")
        self.device = resolve_device(device)
        self.comm = comm
        self.P = comm.axis_size()
        self.b = panel_width
        self.buckets = sorted(
            (tuple(bk) for bk in buckets), key=lambda bk: bk[0] * bk[1])
        for m_loc, n in self.buckets:
            assert m_loc >= 1 and n >= 1, (m_loc, n)
        self.max_slots = max_slots
        self.queue: List[QRRequest] = []
        self.slots: List[Optional[_Slot]] = [None] * max_slots
        self.results: Dict[str, QRResult] = {}
        self.tick_count = 0
        self._pending_kills: List[int] = []
        self._submit_t: Dict[str, float] = {}
        self._rid_counter = itertools.count()
        levels = self.P.bit_length() - 1
        self._points_per_panel = 1 + 2 * levels
        # The resident runner, shared with every SweepOrchestrator over the
        # same comm kind and P.
        self._segment = compiled_segment(comm, self._points_per_panel)
        self._ran_segment = False

    # -- admission ---------------------------------------------------------

    def select_bucket(self, m: int, n_total: int) -> Tuple[int, int]:
        """Smallest bucket fitting an ``(m, n_total)`` problem (n_total
        counts rhs columns: they ride in the bucket's spare width)."""
        for m_loc, n_b in self.buckets:
            if m <= self.P * m_loc and n_total <= n_b:
                return (m_loc, n_b)
        raise ValueError(
            f"no bucket fits ({m}, {n_total}); buckets={self.buckets}")

    def submit(self, A: np.ndarray, rhs: Optional[np.ndarray] = None,
               rid: Optional[str] = None) -> str:
        """Enqueue a request; it joins the resident batch at the next
        panel boundary with a free slot. Returns the request id."""
        A = np.asarray(A, np.float32)
        assert A.ndim == 2, A.shape
        if rhs is not None:
            rhs = np.asarray(rhs, np.float32)
            assert rhs.shape[0] == A.shape[0], (A.shape, rhs.shape)
        if rid is None:
            rid = f"req{next(self._rid_counter)}"
        n_total = A.shape[1] + (0 if rhs is None else rhs.shape[1])
        self.select_bucket(A.shape[0], n_total)  # fail fast on misfit
        self._submit_t[rid] = time.perf_counter()
        self.queue.append(QRRequest(rid=rid, A=A, rhs=rhs))
        return rid

    def kill_lane(self, lane: int) -> None:
        """Schedule a lane death: at the next boundary, ``lane``'s slice of
        every resident tenant's state is poisoned (the fail-stop model:
        one process dies, all tenants it hosted lose that block-row)."""
        assert 0 <= lane < self.P, lane
        self._pending_kills.append(lane)

    def _bucket_of(self, req: QRRequest) -> Tuple[int, int]:
        nrhs = 0 if req.rhs is None else req.rhs.shape[1]
        return self.select_bucket(req.A.shape[0], req.A.shape[1] + nrhs)

    def _layout(self, req: QRRequest, bucket: Tuple[int, int]):
        m_loc, n_b = bucket
        return block_row_layout(_augmented(req), self.P, m_loc, n_b,
                                device=self.device)

    def _admit(self, req: QRRequest, slot_idx: int) -> None:
        bucket = self._bucket_of(req)
        state = initial_sweep_state(self.comm, self._layout(req, bucket),
                                    self.b)
        assert panel_points(state.geom) == self._points_per_panel
        panels_needed = -(-req.k // self.b)
        assert panels_needed <= state.geom.n_panels
        self.slots[slot_idx] = _Slot(
            req=req, bucket=bucket, state=state,
            detector=NaNSentinelDetector(), panels_needed=panels_needed,
            admitted_tick=self.tick_count)

    # -- the service cycle -------------------------------------------------

    def tick(self) -> List[QRResult]:
        """One service cycle: advance every resident slot one panel, then
        the boundary work: inject pending kills, detect and heal, retire
        finished tenants, admit queued requests into freed slots. Returns
        the requests retired this tick."""
        active = [s for s in self.slots if s is not None]
        # 1. advance: one panel segment per resident slot
        for slot in active:
            if slot.state.cursor is not None:
                self._ran_segment = True
                slot.state = self._segment(slot.state)
            slot.panels_done += 1
        # 2. fault injection (the boundary is where deaths surface)
        kills, self._pending_kills = self._pending_kills, []
        for lane in kills:
            for slot in active:
                slot.state = obliterate_state(self.comm, slot.state, lane)
        # 3. detect and heal every tenant (the orchestrator's REBUILD)
        for slot in active:
            newly = slot.detector.poll(self.comm, slot.state)
            if newly:
                self._heal(slot, newly)
        # 4. retire
        retired: List[QRResult] = []
        for i, slot in enumerate(self.slots):
            if slot is not None and slot.panels_done >= slot.panels_needed:
                retired.append(self._retire(slot))
                self.slots[i] = None
        # 5. admit (new tenants join at the panel boundary)
        for i, slot in enumerate(self.slots):
            if slot is None and self.queue:
                self._admit(self.queue.pop(0), i)
        self.tick_count += 1
        return retired

    def run_until_drained(self, max_ticks: int = 10_000) -> Dict[str, QRResult]:
        """Tick until the queue and every slot are empty."""
        for _ in range(max_ticks):
            if not self.queue and all(s is None for s in self.slots):
                return self.results
            self.tick()
        raise RuntimeError(f"service not drained after {max_ticks} ticks")

    @property
    def resident(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def compiled_programs(self) -> int:
        """The reference's count of compiled segment programs. The port has
        no compile cache: its one eager runner serves every bucket, so this
        is 0 until a segment has run and 1 from then on."""
        return int(self._ran_segment)

    # -- recovery ----------------------------------------------------------

    def _heal(self, slot: _Slot, newly: List[int]) -> None:
        geom = slot.state.geom
        point = prev_sweep_point(
            slot.state.cursor, geom.n_panels, geom.levels)
        assert point is not None, (
            "death detected on a tenant that never ran a segment")
        slot.state, events = recover_lanes(
            self.comm, slot.state, sorted(newly), point, set(newly),
            sync=_block_on_state, on_recovered=slot.detector.revive)
        slot.events.extend(events)

    # -- retirement --------------------------------------------------------

    def _partial_R(self, state: SweepState, n_panels: int) -> torch.Tensor:
        """The upper-trapezoidal R of the first ``n_panels`` deposited
        panels, lane 0's copy, on the device (the early-retirement slice of
        ``assemble_R``: identical arithmetic, rows stop at the tenant's
        frontier)."""
        rows = torch.stack(state.R_rows[:n_panels])  # (p, P, b, n_work)
        geom = state.geom
        R = rows.transpose(0, 1).reshape(
            self.P, n_panels * geom.b, geom.n_work)
        return torch.triu(R)[0]

    def _retire(self, slot: _Slot) -> QRResult:
        state, deposited = deposit_boundary(self.comm, slot.state)
        assert deposited >= slot.panels_needed, (deposited, slot.panels_needed)
        req = slot.req
        R, x = _solve(req, self._partial_R(state, slot.panels_needed))
        result = QRResult(
            rid=req.rid, R=R, x=x, bucket=slot.bucket,
            panels=slot.panels_needed,
            ticks_resident=self.tick_count - slot.admitted_tick + 1,
            latency_s=time.perf_counter() - self._submit_t.pop(req.rid),
            events=slot.events)
        self.results[req.rid] = result
        return result

    # -- the static-batch path ---------------------------------------------

    def drain_batched(self) -> Dict[str, QRResult]:
        """Offline bulk mode: group the current queue by bucket and run
        each group through ``caqr_factorize_batched``, bypassing the slot
        machinery. No mid-flight admission or failure handling; the results
        equal the continuous path's bit for bit."""
        by_bucket: Dict[Tuple[int, int], List[QRRequest]] = {}
        queue, self.queue = self.queue, []
        for req in queue:
            by_bucket.setdefault(self._bucket_of(req), []).append(req)
        out: Dict[str, QRResult] = {}
        for bucket, reqs in by_bucket.items():
            stack = torch.stack([self._layout(r, bucket) for r in reqs])
            res = caqr_factorize_batched(
                stack, self.comm, self.b, use_scan=False,
                collect_bundles=True)
            del stack
            geom = sweep_geometry(self.P, *bucket, self.b)
            for i, req in enumerate(reqs):
                # full-sweep R; rows past the tenant's frontier are below
                # its triangle, so the slice equals the early-retired one
                R, x = _solve(req, res.R[i, 0])
                result = QRResult(
                    rid=req.rid, R=R, x=x, bucket=bucket,
                    panels=geom.n_panels, ticks_resident=1,
                    latency_s=time.perf_counter()
                    - self._submit_t.pop(req.rid),
                    events=[])
                self.results[req.rid] = result
                out[req.rid] = result
        return out
