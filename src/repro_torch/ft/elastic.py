"""Elastic execution: SHRINK/BLANK continuation, re-grow and the epoch
splice (port of the SimComm half of ``src/repro/ft/elastic.py``).

On a detected death the dead lane is first healed from its XOR buddies by
the same ``recover_lanes`` REBUILD (the adopter "hosts" the dead slot
until the panel completes), and at the next **panel boundary** the world
re-meshes:

* the pending panel is deposited (``deposit_boundary``), closing an
  *epoch* whose partial R rows are recorded;
* the unconsumed trailing submatrix (every padded row below the ``r*b``
  frontier, live columns ``[r*b:]``) is harvested to the host;
* a transition *plan* re-owns the rows onto the new world (SHRINK:
  survivors renumber and the dead lane's rows are appended to its
  designated adopter's slice; BLANK: the hole keeps a zero-row no-op
  slot; GROW: rows re-scatter evenly over one more live lane) and the
  sweep restarts as a fresh sub-factorization on a wider
  ``sweep_geometry``, whose butterfly pairs are those of the new world.

The harvested submatrix ``T`` has ``T^T T = T_ref^T T_ref`` with
``T_ref`` the failure-free trailing matrix, so the continued sweep
reproduces the remaining R rows up to row signs, within
``kernels.ref.tolerances`` of the failure-free run. The scheduled elastic
driver (``ft_caqr_sweep_elastic``) and the online orchestrator share this
controller, so scheduled == online is bitwise.

A shrunken world keeps a power-of-two slot count: ``"pad"`` (ceil-pow2
slots, trailing ghost slots of zero rows) or ``"fold"`` (floor-pow2 slots,
rows re-split evenly). The harvest and the plan run on the host in numpy,
and the new world's matrix goes back to the state's device.

The training-mesh helpers at the bottom (``make_data_model_mesh``,
``shrink_mesh``, ``reshard``, ``rebalance_batch``) are the training
loop's elastic re-mesh path, on the port's ``repro_torch.dist.compat``
meshes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.caqr import SweepGeometry
from repro_torch.ft.failures import PHASE_LEAF
from repro_torch.ft.semantics import Semantics


def ceil_pow2(x: int) -> int:
    assert x >= 1
    return 1 << (x - 1).bit_length()


def floor_pow2(x: int) -> int:
    assert x >= 1
    return 1 << (x.bit_length() - 1)


@dataclasses.dataclass(frozen=True)
class LaneWorld:
    """One epoch's lane world: ``n_slots`` pow2 butterfly slots, of which
    ``live`` marks the lanes that own rows (ghost and hole slots compute on
    zeros). ``col_base`` is the absolute column of the epoch's first panel
    in the original problem."""

    n_slots: int
    live: Tuple[bool, ...]
    col_base: int = 0

    @property
    def n_live(self) -> int:
        return sum(self.live)

    @property
    def live_lanes(self) -> Tuple[int, ...]:
        return tuple(i for i, ok in enumerate(self.live) if ok)


@dataclasses.dataclass(frozen=True)
class TransitionEvent:
    """One world re-mesh: the boundary it ran at (the just-deposited panel
    frontier ``r`` of the closing epoch), its kind, which lanes left, the
    adopter, and the worlds on both sides."""

    kind: str                      # "shrink" | "blank" | "grow"
    frontier: int                  # panels deposited in the closing epoch
    lanes: Tuple[int, ...]         # dead lanes (old-world ids) or () for grow
    adopter: Optional[int]         # survivor that adopted the rows (old id)
    world_before: LaneWorld
    world_after: LaneWorld


class EpochRecord(NamedTuple):
    """Partial R of one epoch: ``R_part`` holds the epoch's deposited rows
    (``r*b`` of them, epoch column frame) at absolute offset
    ``col_base``."""

    col_base: int
    R_part: np.ndarray
    world: LaneWorld


class ElasticSweepResult(NamedTuple):
    """Outcome of an elastic sweep. ``R`` is the spliced ``(k, n)`` upper
    trapezoid, host-assembled and put on the state's device; ``events``
    are the heal ``RecoveryEvent``s, ``transitions`` the re-meshes,
    ``world`` the final lane world."""

    R: torch.Tensor
    events: List[Any]
    transitions: List[TransitionEvent]
    world: LaneWorld


# -- transition plans ---------------------------------------------------------


def _adopter_for(world: LaneWorld, dead: int) -> int:
    """The survivor that re-owns a dead lane's rows: its XOR buddy at level
    0 when live, else the lowest-indexed live lane."""
    buddy = dead ^ 1
    if buddy < world.n_slots and world.live[buddy]:
        return buddy
    for i in world.live_lanes:
        if i != dead:
            return i
    raise AssertionError("no live adopter")


def plan_transition(
    world: LaneWorld,
    kind: str,
    dead: Tuple[int, ...] = (),
    policy: str = "pad",
) -> Tuple[List[List[int]], LaneWorld, Optional[int]]:
    """Row re-ownership plan for one transition: ``(sources, world_after,
    adopter)``, ``sources[j]`` the OLD slots whose harvested rows
    concatenate into NEW slot ``j`` (an adopted block is appended to the
    adopter's own slice). Every old slot appears exactly once; residue
    rows of non-live slots ride with their nearest live predecessor."""
    assert kind in ("shrink", "blank", "grow"), kind
    live_new = list(world.live)
    for d in dead:
        assert world.live[d], f"lane {d} is not live"
        live_new[d] = False
    assert any(live_new), "no survivors"
    adopter = _adopter_for(
        dataclasses.replace(world, live=tuple(live_new)), dead[0]
    ) if dead else None

    owner: Dict[int, List[int]] = {i: [] for i in range(world.n_slots)
                                   if live_new[i]}
    live_sorted = sorted(owner)
    for i in range(world.n_slots):
        if live_new[i]:
            owner[i].insert(0, i)        # own rows always lead
        elif i in dead:
            owner[adopter].append(i)     # adopted block, appended
        else:
            prev = [j for j in live_sorted if j < i]
            owner[(prev[-1] if prev else live_sorted[0])].append(i)

    if kind == "blank":
        n_slots = world.n_slots
        sources = [owner.get(j, []) for j in range(n_slots)]
        world_after = LaneWorld(n_slots=n_slots, live=tuple(live_new))
        return sources, world_after, adopter
    n_live = sum(live_new) + (1 if kind == "grow" else 0)
    n_slots = max(2, (ceil_pow2 if policy == "pad" else floor_pow2)(n_live))
    if kind == "grow":
        # the caller re-scatters evenly; sources keep slot order
        sources = [owner[j] for j in live_sorted] + [[]] * (
            n_slots - len(live_sorted))
        world_after = LaneWorld(
            n_slots=n_slots, live=tuple(j < n_live for j in range(n_slots)))
        return sources, world_after, adopter
    # shrink: survivors renumber compactly
    if policy == "fold" and len(live_sorted) > n_slots:
        # more survivors than slots: the extra ones fold onto the last
        # slot (their rows re-split evenly at scatter time)
        sources = [owner[j] for j in live_sorted[:n_slots - 1]]
        sources.append([j2 for j in live_sorted[n_slots - 1:]
                        for j2 in owner[j]])
    else:
        sources = [owner[j] for j in live_sorted]
        sources += [[]] * (n_slots - len(sources))
    world_after = LaneWorld(
        n_slots=n_slots,
        live=tuple(j < sum(live_new) if policy == "pad" else True
                   for j in range(n_slots)))
    return sources, world_after, adopter


# -- harvest / scatter --------------------------------------------------------


def harvest_trailing(state, r: int) -> Tuple[List[np.ndarray], int]:
    """Host-side harvest at the deposited frontier ``r``: every slot's
    unconsumed padded rows (writebacks can land on pad rows, so all of
    them ride), live columns ``[r*b : n]``. Returns (per-old-slot row
    blocks, n_remaining_cols)."""
    geom = state.geom
    cut = r * geom.b
    A = state.A.detach().cpu().numpy()
    out = []
    for i in range(geom.P):
        c = min(max(cut - i * geom.m_loc_pad, 0), geom.m_loc_pad)
        out.append(A[i, c:, cut:geom.n])
    return out, geom.n - cut


def scatter_world(
    blocks: List[np.ndarray], n_cols: int, b: int, even: bool = False,
    n_live: Optional[int] = None,
) -> np.ndarray:
    """Scatter per-new-slot row blocks into the SimComm layout
    ``(n_slots, m_loc_new, n_cols)``, zero-padding each slot to the
    largest (``m_loc_new`` a multiple of ``b``). ``even=True`` re-splits
    the concatenation evenly over the first ``n_live`` slots instead."""
    n_slots = len(blocks)
    if even:
        allrows = np.concatenate(
            [blk for blk in blocks if blk.size or len(blk)], axis=0) \
            if any(len(blk) for blk in blocks) else np.zeros((0, n_cols))
        n_live = n_live if n_live is not None else n_slots
        per = -(-len(allrows) // n_live) if len(allrows) else 1
        blocks = [allrows[j * per:(j + 1) * per] if j < n_live
                  else allrows[:0] for j in range(n_slots)]
    m_loc = max(b, -(-max(len(blk) for blk in blocks) // b) * b) \
        if any(len(blk) for blk in blocks) else b
    A = np.zeros((n_slots, m_loc, n_cols), dtype=np.float32)
    for j, blk in enumerate(blocks):
        if len(blk):
            A[j, :len(blk)] = blk
    return A


# -- the controller (shared by the scheduled oracle and the orchestrator) ----


class ElasticController:
    """State machine of the elastic semantics, shared by the scheduled
    driver (``ft_caqr_sweep_elastic``) and the online orchestrator. Deaths
    are noted (after the buddy heal) and applied at the next panel
    boundary; grow requests queue the same way. ``finish`` splices the
    epochs' partial R blocks into the final ``(k, n)`` R."""

    def __init__(self, semantics: Semantics, geom: SweepGeometry,
                 policy: str = "pad"):
        assert semantics in (Semantics.SHRINK, Semantics.BLANK), semantics
        assert policy in ("pad", "fold"), policy
        self.semantics = semantics
        self.policy = policy
        self.k_total = geom.k
        self.n_total = geom.n
        self.b = geom.b
        self.world = LaneWorld(n_slots=geom.P, live=(True,) * geom.P)
        self.epochs: List[EpochRecord] = []
        self.transitions: List[TransitionEvent] = []
        self._pending_dead: List[int] = []
        self._pending_grow = 0
        self._finished = False
        self._device: Optional[torch.device] = None

    # -- requests ----------------------------------------------------------

    def note_deaths(self, lanes: List[int]) -> None:
        """A healed death awaiting its boundary transition."""
        self._pending_dead.extend(
            l for l in lanes if l not in self._pending_dead)

    def request_grow(self) -> None:
        """A returning lane re-joins at the next panel boundary."""
        self._pending_grow += 1

    @property
    def pending(self) -> bool:
        return bool(self._pending_dead or self._pending_grow)

    def ready(self, cursor) -> bool:
        """Transitions run only at panel boundaries (cursor at a leaf
        point, or past the end)."""
        return self.pending and (cursor is None or cursor[1] == PHASE_LEAF)

    # -- the transition ----------------------------------------------------

    def _close_epoch(self, comm, state) -> Tuple[Any, int]:
        from repro_torch.ft.online.state import deposit_boundary

        self._device = state.A.device
        state, r = deposit_boundary(comm, state)
        if r:
            rows = np.concatenate(
                [x[0].detach().cpu().numpy() for x in state.R_rows], axis=0)
            n_e = self.n_total - self.world.col_base
            self.epochs.append(EpochRecord(
                col_base=self.world.col_base,
                R_part=np.triu(rows)[:, :n_e],
                world=self.world,
            ))
        return state, r

    def transition(self, comm, state):
        """Apply the pending transition at a panel boundary: deposit,
        record the closing epoch, harvest, re-own, and return the new
        ``(comm, state)`` with the cursor at the sub-sweep's first point
        (``(None, state)`` when the factorization completed in the closing
        epoch and only world bookkeeping changed)."""
        from repro_torch.core.comm import SimComm
        from repro_torch.ft.online.state import initial_sweep_state

        assert self.ready(state.cursor)
        if self._pending_dead:
            kind = ("shrink" if self.semantics is Semantics.SHRINK
                    else "blank")
            dead = tuple(self._pending_dead)
            self._pending_dead = []
        else:
            kind, dead = "grow", ()
            self._pending_grow -= 1

        if self._finished:
            # an earlier transition at the final boundary already closed
            # the last epoch: further requests are bookkeeping only
            r = 0
        else:
            state, r = self._close_epoch(comm, state)
        before = self.world
        sources, after, adopter = plan_transition(
            before, kind, dead, policy=self.policy)
        after = dataclasses.replace(
            after, col_base=before.col_base + r * self.b)
        self.transitions.append(TransitionEvent(
            kind=kind, frontier=r, lanes=dead, adopter=adopter,
            world_before=before, world_after=after))
        self.world = after

        if state.cursor is None:
            self._finished = True
            return None, state

        blocks, n_cols = harvest_trailing(state, r)
        even = kind == "grow" or self.policy == "fold"
        merged = [np.concatenate([blocks[i] for i in srcs], axis=0)
                  if srcs else blocks[0][:0] for srcs in sources]
        A_new = scatter_world(merged, n_cols, self.b, even=even,
                              n_live=after.n_live)
        new_comm = SimComm(after.n_slots)
        return new_comm, initial_sweep_state(
            new_comm, torch.from_numpy(A_new).to(state.A.device), self.b)

    # -- completion --------------------------------------------------------

    def finish(self, comm, state, events) -> ElasticSweepResult:
        """Close the final epoch (cursor past the end) and splice every
        epoch's partial R into the original problem's ``(k, n)`` R."""
        if not self._finished:
            assert state.cursor is None, state.cursor
            self._close_epoch(comm, state)
            self._finished = True
        R = np.zeros((self.k_total, self.n_total), dtype=np.float32)
        for ep in self.epochs:
            nrows = min(len(ep.R_part), self.k_total - ep.col_base)
            R[ep.col_base:ep.col_base + nrows, ep.col_base:] = \
                ep.R_part[:nrows]
        dev = self._device if self._device is not None else state.A.device
        return ElasticSweepResult(
            R=torch.from_numpy(R).to(dev), events=list(events),
            transitions=list(self.transitions), world=self.world)


# -- the scheduled elastic driver (the differential oracle) -------------------


def ft_caqr_sweep_elastic(
    A0,
    comm,
    panel_width: int,
    schedule=None,
    semantics: Semantics = Semantics.SHRINK,
    policy: str = "pad",
    grow_at=None,
    scheme=None,
) -> ElasticSweepResult:
    """Scheduled elastic sweep: kills fire at scheduled sweep points, each
    is healed from its buddies (the same ``recover_lanes`` as REBUILD),
    and the world re-meshes at the next panel boundary under
    ``semantics``. The oracle of the online elastic path, which runs this
    controller. ``grow_at`` (a sweep point of the world it fires in)
    schedules a re-grow. Schedule keys address the epoch running when the
    point comes up: after a transition the sub-sweep's panels restart at
    0, as an online ``ScriptedKiller`` sees them."""
    from repro_torch.core.comm import SimComm
    from repro_torch.ft.coding import XORPairScheme
    from repro_torch.ft.driver import _block_on_state, recover_lanes
    from repro_torch.ft.failures import Detector
    from repro_torch.ft.online.state import initial_sweep_state, sweep_step

    assert isinstance(comm, SimComm), "the scheduled oracle runs on SimComm"
    scheme = XORPairScheme() if scheme is None else scheme
    state = initial_sweep_state(comm, A0, panel_width)
    ctrl = ElasticController(semantics, state.geom, policy=policy)
    detector = Detector(comm.axis_size(), schedule)
    events: List[Any] = []
    while True:
        while state.cursor is not None:
            point = state.cursor
            state = sweep_step(comm, state)
            # re-encode the parity slots before this point's kills fire;
            # after a transition the generator follows the new world size
            state = scheme.refresh(comm, state)
            newly = detector.begin_step(point)
            if newly:
                state, evs = recover_lanes(
                    comm, state, newly, point, detector.dead,
                    sync=_block_on_state, on_recovered=detector.revive,
                    scheme=scheme)
                events.extend(evs)
                ctrl.note_deaths(newly)
            if point == grow_at:
                ctrl.request_grow()
            if ctrl.ready(state.cursor):
                new_comm, state = ctrl.transition(comm, state)
                if new_comm is None:
                    break
                comm = new_comm
        if not ctrl.pending:
            break
        new_comm, state = ctrl.transition(comm, state)
        if new_comm is None:
            continue  # bookkeeping only: drain any remaining requests
        comm = new_comm
    return ctrl.finish(comm, state, events)


# -- training-loop elastic re-mesh (mesh-level helpers) ----------------------


def make_data_model_mesh(n_data: int, n_model: int, devices=None,
                         device="cuda"):
    """A (data, model) mesh over the first ``n_data * n_model`` of
    ``devices`` (rank ids; default all of them in order)."""
    from repro_torch.dist import compat

    need = n_data * n_model
    devices = np.arange(need) if devices is None else np.asarray(devices).ravel()
    assert len(devices) >= need, (len(devices), need)
    arr = devices[:need].reshape(n_data, n_model)
    return compat.make_mesh(arr.shape, ("data", "model"), devices=arr,
                            device=device)


def shrink_mesh(mesh, dead_data_lane: int):
    """Drop one data-axis row of the mesh (the failed host's devices)."""
    from repro_torch.dist import compat

    survivors = np.delete(np.asarray(mesh.devices), dead_data_lane, axis=0)
    return compat.make_mesh(survivors.shape, mesh.axis_names,
                            devices=survivors, device=mesh._device)


def reshard(t: Any, mesh, spec_fn=None) -> Any:
    """Every leaf laid out on ``mesh``: each device's block by the spec
    (``spec_fn(leaf) -> PartitionSpec``; default fully replicated, the
    parameters of pure data parallelism), then the leaf reassembled from
    the blocks, so the values pass through unchanged."""
    from repro_torch import tree
    from repro_torch.dist.compat import PartitionSpec
    from repro_torch.dist.params_sharding import NamedSharding

    def put(leaf):
        sh = NamedSharding(mesh, PartitionSpec() if spec_fn is None
                           else spec_fn(leaf))
        blocks = {c: sh.block(leaf, c) for c in np.ndindex(mesh.devices.shape)}
        return sh.assemble(blocks, leaf.shape)

    return tree.map(put, t)


def rebalance_batch(global_batch: int, n_lanes_old: int,
                    n_lanes_new: int) -> Tuple[int, int]:
    """Keep the global batch if it divides, else shrink it to the nearest
    multiple. Returns (new_global_batch, per_lane)."""
    per = global_batch // n_lanes_new
    return per * n_lanes_new, per
