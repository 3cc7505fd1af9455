"""One process per lane: the FT-CAQR sweep across the ranks of a
``torch.distributed`` group (port of ``src/repro/launch/spmd_qr.py``;
paper §II's execution model).

A lane is a rank. ``make_lane_group(n)`` spawns n rank processes
(``torch.multiprocessing``, start method ``spawn``) joined in a gloo group,
on the CPU in the tests (``device="cpu"``) and on the card by default,
where every rank shares ``cuda:0`` and gloo's transfers go through pinned
host buffers. Each rank runs the same lane-batched code as the
single-process path over ``AxisComm``, with a unit lane axis where
``SimComm`` carries P: K1-K4 launch over one lane, every exchange is a
collective of the group, and a REBUILD's buddy reads are point-to-point
transfers from the one source its ledger names.

``ft_caqr_sweep_spmd`` block-shards the rows of a whole matrix over the
ranks, runs ``FTSweepDriver`` over ``AxisComm`` in each, and returns an
``FTSweepResult`` in the ``SimComm`` layout, leaf for leaf (the lane axes
of ``_FACTORS_LANE_AXIS`` and ``_BUNDLE_LANE_AXIS``), with the ranks'
ledger, so it compares with a single-process run by ``torch.equal``. The
``*_lanes`` drivers do the same for ``caqr_factorize_spmd``,
``caqr_lstsq`` over ``AxisComm``, ``ft_tsqr_spmd`` and
``dist_orthonormalize_spmd``. The rank bodies, ``ft_caqr_sweep_rank`` and
``mds_parity_rank``, also run inside a ``torch.distributed`` job its caller
set up.

Results come back to the caller through ``torch.multiprocessing``'s
sharing (CUDA IPC on the card), and each rank keeps its last result alive
until its next task; every driver joins or copies them into tensors the
caller owns before it returns (and before a group it spawned closes). A
rank that raises makes the caller raise with the
rank's message; a rank that dies, or a task that outlasts the group's
timeout, closes the group (its processes are terminated) and raises, so
no rank carries on alone and nothing waits past the timeout. The gloo
group is created with the same timeout, so a collective that a peer never
enters raises in the rank.

The online path (``ft_caqr_sweep_online_spmd``, and with SHRINK/BLANK
``ft_caqr_sweep_elastic_spmd``) keeps the reference's split: the host
orchestrator (``SweepOrchestrator``) runs in the caller's process on the
global ``SweepState`` in the ``SimComm`` layout, on the group's device;
detection, fault hooks, REBUILD, the ``MDSScheme`` refresh and decode,
the store and elastic transitions all run there between points, and only
``sweep_step`` runs in the ranks, over ``AxisComm``, one point a task
(``SpmdSweepStep``, the orchestrator's ``step_fn``). A rank keeps its
local state between points, and leaves travel only when they changed:
the parent ships the slices of the leaves its hooks or recovery replaced,
a rank answers with the tensors its step made, both through staging
buffers shared once. An elastic re-mesh runs the new world on a gloo
subgroup of the first ranks (``make_spmd_step_factory``); no rank is
spawned.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import queue
import time
import traceback
import uuid
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.caqr import CAQRResult, PanelFactors, caqr_factorize_spmd
from repro_torch.core.comm import (
    AxisComm,
    SimComm,
    StagingStats,
    axis_comm,
    lane_block,
)
from repro_torch.core.lstsq import caqr_lstsq
from repro_torch.core.trailing import RecoveryBundle
from repro_torch.core.tsqr import (
    DistTSQRFactors,
    dist_orthonormalize_spmd,
    ft_tsqr_spmd,
)
from repro_torch.ft.coding import MDSScheme
from repro_torch.ft.driver import FTSweepDriver, FTSweepResult
from repro_torch.ft.failures import FailureSchedule, iter_sweep_points
from repro_torch.ft.online.state import (
    SweepState,
    flat_arrays,
    initial_sweep_state,
    map_state,
    replace_arrays,
    run_steps,
    state_lane_axes,
    sweep_step,
)
from repro_torch.ft.semantics import Semantics
from repro_torch.kernels import backend, build
from repro_torch.kernels.backend import resolve_device

# Lane-axis position of every per-lane leaf in the SimComm result layout;
# each rank's result carries a unit axis there.
_R_LANE_AXIS = 0
_FACTORS_LANE_AXIS = PanelFactors(
    leaf_Y=1, leaf_T=1, level_Y2=2, level_T=2,
    row_start=1, active=1, target=1,
)
_BUNDLE_LANE_AXIS = RecoveryBundle(
    W=2, C_self=2, C_buddy=2, Y2=2, T=2, self_was_top=2,
)
_TSQR_LANE_AXIS = DistTSQRFactors(leaf_Y=0, leaf_T=0, level_Y2=1, level_T=1,
                                  R=0)
# Seconds the caller waits for the other ranks' reports once one rank has
# raised: ranks that raise the same error (an unrecoverable schedule is
# found by every rank at the same point) leave the group usable; a rank
# still silent after it closes the group.
_ERROR_GRACE_S = 5.0


class RankError(RuntimeError):
    """A rank raised an exception that cannot be re-created by type, or
    died, or did not report within the group's timeout."""


class RankReport(NamedTuple):
    """One rank's account of one task: seconds (the device synchronised
    before and after), K1-K6 launches (``backend.LAUNCHES`` counted from 0
    at the task's start) and the kernels' launches inside wide calls
    (``backend.SUB_LAUNCHES``), its ``AxisComm``'s staging statistics, and
    where it was measured (a body of ``compat.run_manual``), its peak
    device memory in the task."""

    rank: int
    seconds: float
    launches: Dict[str, int]
    staged: Dict[str, float]
    peak_bytes: int = 0


def make_lane_mesh(n_lanes: Optional[int] = None, axis_name: str = "qr",
                   device="cuda", group: Optional["LaneGroup"] = None):
    """A one-axis mesh (``repro_torch.dist.compat.Mesh``), one lane a rank:
    ``n_lanes`` (default: ``group``'s size, else ``pow2_lanes()``) ranks on
    ``device``, spawned at the mesh's first use, or the first ``n_lanes``
    ranks of ``group``. The counterpart of the reference's
    ``make_lane_mesh``; close the mesh when done (a shared group stays
    open)."""
    from repro_torch.dist import compat

    if n_lanes is None:
        n_lanes = group.size if group is not None else pow2_lanes()
    return compat.make_mesh((n_lanes,), (axis_name,), device=device,
                            group=group)


def pow2_lanes(n: Optional[int] = None) -> int:
    """Largest power of two at most ``n`` (default: the CPU count, one rank
    a core): the butterfly needs 2^k lanes."""
    if n is None:
        n = os.cpu_count() or 1
    if n < 1:
        raise ValueError(f"need at least one lane, got {n}")
    return 1 << (n.bit_length() - 1)


# -- the rank processes ------------------------------------------------------


def _init_rank(rank: int, n: int, port: int, device: str,
               timeout_s: float) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        unbuilt = build.missing()
        if unbuilt:
            raise RuntimeError(
                f"kernels {unbuilt} are not built: a rank loads the "
                "libraries its parent built (build.build_all()) and does "
                "not start nvcc")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    timeout = datetime.timedelta(seconds=timeout_s)
    store = dist.TCPStore("127.0.0.1", port, is_master=False, timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n,
                            timeout=timeout)


def _failure(rank: int, exc: BaseException):
    """The report of an exception: the exception itself when it pickles
    (so the caller can raise its type), its text and the traceback."""
    try:
        pickle.dumps(exc)
        sent = exc
    except Exception:
        sent = None
    return rank, "error", (sent, f"{type(exc).__name__}: {exc}",
                           traceback.format_exc())


def _rank_main(rank: int, n: int, port: int, device: str, timeout_s: float,
               tasks, results) -> None:
    """A rank's loop: join the group, then run each task the caller sends
    and put its result; keep the result alive until the next task (the
    caller may still be reading it through shared memory)."""
    try:
        _init_rank(rank, n, port, device, timeout_s)
    except Exception as e:
        results.put(_failure(rank, e))
        return
    results.put((rank, "ready", None))
    keep = None
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        keep = None
        try:
            keep = fn(*args)
        except Exception as e:
            results.put(_failure(rank, e))
        else:
            results.put((rank, "ok", keep))
    import torch.distributed as dist

    dist.destroy_process_group()


# A rank's gloo subgroups by their ranks (``LaneGroup.groups``); a rank
# outside one holds ``GroupMember.NON_GROUP_MEMBER`` there.
_GROUPS: Dict[tuple, Any] = {}


def _new_groups(lines: Sequence[tuple], timeout_s: float) -> None:
    import torch.distributed as dist

    for line in lines:
        _GROUPS[line] = dist.new_group(
            list(line), timeout=datetime.timedelta(seconds=timeout_s))


def rank_group(ranks: Sequence[int]):
    """In a rank: the process group of ``ranks`` (None, the default group,
    when they are the whole group; else a subgroup ``LaneGroup.groups``
    made)."""
    import torch.distributed as dist

    ranks = tuple(ranks)
    if ranks == tuple(range(dist.get_world_size())):
        return None
    return _GROUPS[ranks]


def _shutdown(procs, tasks) -> None:
    for q in tasks:
        try:
            q.put(None)
        except (OSError, ValueError):
            pass
    for p in procs:
        p.join(timeout=10)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(timeout=10)


class LaneGroup:
    """``size`` spawned rank processes in one gloo group, one lane each, on
    ``device``. ``run(fn, *args, each=...)`` calls ``fn`` in every rank (a
    module-level function: it is pickled by name) and returns the ranks'
    results in rank order. Close it (or use it as a context manager) to
    stop the processes.

    ``timeout_s`` bounds every collective in a rank and every task."""

    def __init__(self, n_lanes: int, device="cuda", timeout_s: float = 120.0):
        import torch.distributed as dist

        if n_lanes < 2 or n_lanes & (n_lanes - 1):
            raise ValueError(f"a lane group needs a power of two >= 2 "
                             f"ranks, got {n_lanes}")
        self.device = resolve_device(device)
        self.size = n_lanes
        self.timeout_s = timeout_s
        self.last_reports: List[RankReport] = []
        # the online entries' account of their last run (``SpmdSweepStep
        # .stats`` summed over the run's worlds)
        self.last_steps: Dict[str, Any] = {}
        self.closed = False
        self._subgroups = set()
        timeout = datetime.timedelta(seconds=timeout_s)
        # the store binds port 0: the system picks a free port, so groups
        # made at once by several test workers do not collide
        self._store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                                    wait_for_workers=False, timeout=timeout)
        ctx = torch.multiprocessing.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(n_lanes)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, n_lanes, self._store.port, str(self.device), timeout_s,
                self._tasks[r], self._results))
            for r in range(n_lanes)]
        for p in self._procs:
            p.start()
        self._finalizer = weakref.finalize(self, _shutdown, self._procs,
                                           self._tasks)
        try:
            self._collect("ready")
        except BaseException:
            self._abort()
            raise

    def __enter__(self) -> "LaneGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Stop the rank processes (each finishes its loop, else it is
        terminated)."""
        self.closed = True
        self._finalizer()
        self._store = None

    def subgroup(self, n: int) -> None:
        """Make every rank join a gloo subgroup of the first ``n`` ranks
        (once per ``n``)."""
        self.groups([tuple(range(n))])

    def groups(self, lines: Sequence[Sequence[int]]) -> None:
        """Make every rank join a gloo subgroup for each tuple of ranks in
        ``lines`` not made before (the whole group is the default group):
        ``torch.distributed.new_group`` must be entered by every rank of the
        group, in the same order, members or not. ``rank_group`` finds them
        in a rank."""
        new = [tuple(line) for line in lines
               if len(line) < self.size and tuple(line) not in self._subgroups]
        new = list(dict.fromkeys(new))
        if new:
            self.run(_new_groups, new, self.timeout_s)
            self._subgroups.update(new)

    def _abort(self) -> None:
        """Terminate every rank: the group cannot go on."""
        self.closed = True
        self._finalizer.detach()
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=10)
        self._store = None

    def run(self, fn: Callable, *args, each: Optional[Sequence[tuple]] = None,
            ranks: Optional[int] = None) -> List[Any]:
        """``fn(*each[r], *args)`` in rank r (``fn(*args)`` without
        ``each``) of the first ``ranks`` ranks (default all; the others get
        no task); the results in rank order. Raises what a rank raised
        (same type where it can be re-created, with the rank's message and
        traceback), or ``RankError`` when a rank died or the task outlasted
        the group's timeout; the group is then closed."""
        if self.closed:
            raise RuntimeError("the lane group is closed")
        n = self.size if ranks is None else ranks
        # a queue pickles in a background thread and only prints what fails
        # there, so check here that the ranks can import the function
        pickle.dumps(fn)
        for r, q in enumerate(self._tasks[:n]):
            q.put((fn, tuple(each[r] if each is not None else ()) + args))
        return self._collect("ok", n)

    def _collect(self, kind: str, n: Optional[int] = None) -> List[Any]:
        n = self.size if n is None else n
        got: Dict[int, tuple] = {}
        dead_since: Dict[int, float] = {}
        now = time.monotonic()
        deadline = now + self.timeout_s
        while len(got) < n:
            now = time.monotonic()
            if now >= deadline:
                break
            try:
                rank, what, val = self._results.get(
                    timeout=min(0.5, deadline - now))
            except queue.Empty:
                # a rank that exited may still have a report in the pipe
                for r, p in enumerate(self._procs[:n]):
                    if r not in got and not p.is_alive():
                        t = dead_since.setdefault(r, now)
                        if now - t > _ERROR_GRACE_S:
                            got[r] = ("error", (None, f"rank {r} exited with "
                                                f"code {p.exitcode}", ""))
                continue
            got[rank] = (what, val)
            if what == "error":
                deadline = min(deadline, time.monotonic() + _ERROR_GRACE_S)
        errors = sorted(r for r, (what, _) in got.items() if what == "error")
        silent = [r for r in range(n) if r not in got]
        if silent:
            self._abort()
        if errors:
            exc, msg, tb = got[errors[0]][1]
            text = f"rank {errors[0]}: {msg}" + (
                f"\n--- rank {errors[0]} traceback ---\n{tb}" if tb else "")
            if exc is not None:
                try:
                    err = type(exc)(text)
                except TypeError:
                    err = RankError(text)
                raise err
            raise RankError(text)
        if silent:
            raise RankError(f"ranks {silent} did not report within "
                            f"{self.timeout_s} s; the group is closed")
        assert all(what == kind for what, _ in got.values()), got
        return [got[r][1] for r in range(n)]


def make_lane_group(n_lanes: Optional[int] = None, device="cuda",
                    timeout_s: float = 120.0) -> LaneGroup:
    """Spawn ``n_lanes`` ranks (a power of two; default ``pow2_lanes()``)
    in one gloo group on ``device`` (the card by default; raises without
    CUDA unless ``device="cpu"``). On the card, build the kernels first
    (``repro_torch.kernels.build.build_all()``): the ranks load the built
    libraries and start no nvcc. ``make_lane_mesh`` wraps one in a
    mesh."""
    return LaneGroup(pow2_lanes() if n_lanes is None else n_lanes, device,
                     timeout_s)


# -- rank bodies ---------------------------------------------------------------


def sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def launch_counts() -> Dict[str, int]:
    """This process's launch counters: K1-K6 and the kernels inside wide
    calls."""
    return {**backend.LAUNCHES, **backend.SUB_LAUNCHES}


def measured_call(device: torch.device, body: Callable) -> tuple:
    """``(body(), seconds, launches)``: the device synchronised before and
    after, the launches counted from 0 at the start."""
    before = launch_counts()
    sync_device(device)
    t0 = time.perf_counter()
    out = body()
    sync_device(device)
    seconds = time.perf_counter() - t0
    return out, seconds, {k: n - before[k] for k, n in launch_counts().items()}


def _measured(comm: AxisComm, device: torch.device, body: Callable):
    """``(body(), RankReport)``: seconds, launches and staging of one
    rank body."""
    out, seconds, launches = measured_call(device, body)
    return out, RankReport(comm.rank, seconds, launches,
                           dataclasses.asdict(comm.stats))


def _own(x, device: str) -> torch.Tensor:
    """The rank's own copy of a block (a block shared by the caller stays
    the caller's)."""
    return lane_block(torch.as_tensor(x).to(device, copy=True))


def ft_caqr_sweep_rank(A_local: torch.Tensor, group, panel_width: int,
                       schedule: Optional[FailureSchedule] = None,
                       scheme=None) -> FTSweepResult:
    """The rank body of ``ft_caqr_sweep_spmd``: ``FTSweepDriver`` over
    ``AxisComm(group)`` (a process group, None for the default group, or
    an ``AxisComm``) on this rank's block-row ``(m_loc, n)`` or
    ``(1, m_loc, n)``. Every rank of the group calls it with the same
    schedule and scheme; the result keeps a unit lane axis where the
    ``SimComm`` result carries P, and every rank holds the same ledger."""
    return FTSweepDriver(lane_block(A_local), axis_comm(group), panel_width,
                         schedule, scheme=scheme).run()


def mds_parity_rank(A_local: torch.Tensor, group, panel_width: int, f: int,
                    point) -> tuple:
    """The rank body of ``mds_parity_lanes``: the sweep's state after
    ``point`` and its ``MDSScheme(f)`` parity slots, encoded across the
    ranks of ``group``."""
    comm = axis_comm(group)
    state = initial_sweep_state(comm, lane_block(A_local), panel_width)
    geom = state.geom
    n = list(iter_sweep_points(geom.n_panels, geom.levels)).index(
        tuple(point)) + 1
    return MDSScheme(f=f).refresh(comm, run_steps(comm, state, n)).code


def _task(blocks: tuple, entry: Callable, device: str, args: tuple,
          kw: dict):
    """A rank's task: ``entry(*blocks, comm, *args, **kw)`` on the rank's
    own copies of its blocks over a fresh ``AxisComm``, measured."""
    comm = AxisComm()
    own = [_own(x, device) for x in blocks]
    return _measured(comm, own[0].device,
                     lambda: entry(*own, comm, *args, **kw))


# -- the caller's side ---------------------------------------------------------


def shard_rows(A, n_lanes: int) -> List[torch.Tensor]:
    """The contiguous block-rows of a whole ``(m, q)`` matrix (a numpy
    array or a tensor), one a rank; ``m`` must divide by ``n_lanes`` (each
    lane re-reads its own block-row on REBUILD, the paper's data-source
    model). A tensor's blocks are views of it."""
    A = torch.as_tensor(np.asarray(A) if isinstance(A, np.ndarray) else A)
    m = A.shape[0]
    if m % n_lanes:
        raise ValueError(f"rows ({m}) must block-shard evenly over "
                         f"{n_lanes} lanes")
    return list(A.split(m // n_lanes))


def gather_lanes(parts: Sequence, axes):
    """The ranks' results (each with a unit lane axis) joined along their
    lane axes into the ``SimComm`` layout: ``axes`` is an int or a
    NamedTuple of ints matching ``parts[0]``; None leaves stay None."""
    if parts[0] is None:
        return None
    if isinstance(axes, int):
        return torch.cat(list(parts), dim=axes)
    return type(axes)(*(gather_lanes([p[i] for p in parts], ax)
                        for i, ax in enumerate(axes)))


def _run(group: LaneGroup, entry: Callable, mats: tuple, *args, **kw
         ) -> List[Any]:
    """``entry(*blocks, comm, *args, **kw)`` in every rank on its block-rows
    of the whole matrices ``mats``; the results in rank order, the ranks'
    reports in ``group.last_reports``."""
    blocks = zip(*(shard_rows(X, group.size) for X in mats))
    outs = group.run(_task, entry, str(group.device), args, kw,
                     each=[(blk,) for blk in blocks])
    group.last_reports = [rep for _, rep in outs]
    return [out for out, _ in outs]


def caqr_factorize_lanes(A, panel_width: int, group: LaneGroup, **kw
                         ) -> CAQRResult:
    """``caqr_factorize_spmd`` in every rank of ``group`` on the block-rows
    of the whole matrix ``A``; the ``CAQRResult`` in the ``SimComm``
    layout."""
    outs = _run(group, caqr_factorize_spmd, (A,), panel_width, **kw)
    return CAQRResult(
        R=gather_lanes([o.R for o in outs], _R_LANE_AXIS),
        factors=gather_lanes([o.factors for o in outs], _FACTORS_LANE_AXIS),
        bundles=(None if outs[0].bundles is None else gather_lanes(
            [o.bundles for o in outs], _BUNDLE_LANE_AXIS)))


def _replicated(xs: List[torch.Tensor], what: str) -> torch.Tensor:
    """Rank 0's copy of a value every rank holds, checked equal on all; a
    copy the caller owns (the ranks' results are shared memory)."""
    if not all(torch.equal(x, xs[0]) for x in xs[1:]):
        raise RankError(f"the ranks' {what} differ")
    return xs[0].clone()


def caqr_lstsq_lanes(A, rhs, panel_width: int, group: LaneGroup
                     ) -> torch.Tensor:
    """``caqr_lstsq`` over ``AxisComm`` in every rank on the block-rows of
    ``A`` (m, n) and ``rhs`` (m, q); x (n, q), checked equal on every
    rank."""
    return _replicated(_run(group, caqr_lstsq, (A, rhs), panel_width), "x")


def mds_parity_lanes(A, panel_width: int, f: int, point,
                     group: LaneGroup) -> tuple:
    """The ``MDSScheme(f)`` parity slots (one ``(f, *byte_shape)`` uint8
    tensor per protected leaf) of the sweep's state after ``point``,
    encoded across the ranks: what ``FTSweepDriver`` holds there. Checked
    equal on every rank."""
    outs = _run(group, mds_parity_rank, (A,), panel_width, f, point)
    if any(len(code) != len(outs[0]) for code in outs[1:]):
        raise RankError("the ranks' parity slots differ")
    return tuple(_replicated(list(xs), "parity slots") for xs in zip(*outs))


def ft_tsqr_lanes(A, group: LaneGroup) -> DistTSQRFactors:
    """``ft_tsqr_spmd`` in every rank; the factors in the ``SimComm``
    layout."""
    outs = _run(group, ft_tsqr_spmd, (A,))
    return gather_lanes(outs, _TSQR_LANE_AXIS)


def dist_orthonormalize_lanes(A, group: LaneGroup):
    """``dist_orthonormalize_spmd`` in every rank: (Q, R) in the ``SimComm``
    layout, (P, m_loc, b) and (P, b, b)."""
    outs = _run(group, dist_orthonormalize_spmd, (A,))
    return (gather_lanes([q for q, _ in outs], 0),
            gather_lanes([r for _, r in outs], 0))


def ft_caqr_sweep_spmd(A, panel_width: int,
                       schedule: Optional[FailureSchedule] = None,
                       group: Optional[LaneGroup] = None, scheme=None,
                       device="cuda") -> FTSweepResult:
    """Run the windowed FT-CAQR sweep with one process per lane.

    A: the whole ``(m, n)`` matrix; its rows are block-sharded over the
        ranks (``m`` must divide by the lane count). Any per-lane shape
        ``ft_caqr_sweep`` accepts works: ragged and wide geometries run at
        the padded ``sweep_geometry`` in every rank.
    panel_width: b.
    schedule: the lane-death schedule every rank runs; None: failure-free.
    group: a ``LaneGroup``; None spawns ``make_lane_group(device=device)``
        for this call and closes it after.
    scheme: the coding scheme (``XORPairScheme`` by default, or
        ``MDSScheme(f=...)``).

    Returns ``FTSweepResult`` in the ``SimComm`` layout: ``R`` is
    ``(P, min(m, n), n)``, factors and bundles carry the lane axis where
    a single-process run puts it, and ``events`` is the ranks' ledger
    (checked equal on every rank; ``elapsed_s`` is rank 0's).
    """
    own = group is None
    if own:
        group = make_lane_group(device=device)
    try:
        outs = _run(group, ft_caqr_sweep_rank, (A,), panel_width, schedule,
                    scheme)
        ledgers = [[(e.point, e.lane, e.reads) for e in o.events]
                   for o in outs]
        if any(led != ledgers[0] for led in ledgers[1:]):
            raise RankError(f"the ranks' REBUILD ledgers differ: {ledgers}")
        # joined into tensors the caller owns while the ranks, whose memory
        # the results share, still run
        return FTSweepResult(
            R=gather_lanes([o.R for o in outs], _R_LANE_AXIS),
            factors=gather_lanes([o.factors for o in outs],
                                 _FACTORS_LANE_AXIS),
            bundles=gather_lanes([o.bundles for o in outs],
                                 _BUNDLE_LANE_AXIS),
            events=outs[0].events)
    finally:
        if own:
            group.close()


# -- the online path: the host orchestrator over the ranks ---------------------


class _Held:
    """A leaf that the receiving side already holds under the flat key
    ``key`` (``flat_arrays``): in the parent's message, the rank's leaf of
    the last point."""

    __slots__ = ("key",)

    def __init__(self, key: str):
        self.key = key


class _HostOnly:
    """A rank's stand-in for a leaf with no lane axis (the parity slots):
    the parent keeps it, and ``sweep_step`` passes it through."""

    __slots__ = ()


class _Slot:
    """A leaf whose bytes travel in a staging buffer (the message names
    its offset), or, in a rank's answer, any leaf of the output state's
    structure."""

    __slots__ = ()


_SLOT = _Slot()
# Byte alignment of each leaf in a staging buffer.
_ALIGN = 256
# A staging buffer that carried more than this many bytes to a rank is
# released by both sides after the point (a kill ships the whole state
# once, steady points ship nothing); below it a buffer grows with a
# quarter to spare.
_STAGING_KEEP = 1 << 26


def staging_layout(leaves: Dict[str, torch.Tensor]) -> tuple:
    """``(plan, nbytes)``: the leaves packed one after another into a byte
    buffer, ``plan`` a tuple of (key, offset, dtype, shape)."""
    plan, off = [], 0
    for k, v in leaves.items():
        plan.append((k, off, v.dtype, tuple(v.shape)))
        off += -(-v.numel() * v.element_size() // _ALIGN) * _ALIGN
    return tuple(plan), off


def staging_slot(buf: torch.Tensor, off: int, dtype, shape) -> torch.Tensor:
    """The leaf at ``off`` of the byte buffer ``buf``, a view."""
    n = math.prod(shape) * dtype.itemsize
    return buf[off:off + n].view(dtype).view(shape)


def staging_buffer(nbytes: int, device: torch.device,
                   old: Optional[torch.Tensor]) -> tuple:
    """``(buffer, fresh)``: ``old`` when it holds ``nbytes``, else a new
    byte buffer (with a quarter to spare up to ``_STAGING_KEEP``), in shared
    memory on the CPU (the other process maps it once, when it is first
    sent)."""
    if old is not None and old.numel() >= nbytes:
        return old, False
    spare = nbytes // 4 if nbytes <= _STAGING_KEEP else 0
    buf = torch.empty(max(nbytes + spare, _ALIGN), dtype=torch.uint8,
                      device=device)
    if buf.device.type == "cpu":
        buf.share_memory_()
    return buf, True


class _RankSession:
    """A rank's side of one runner: its ``AxisComm``, its output state of
    the last point (its leaves, with ``_HostOnly`` where the parent keeps
    one), the parent's staging buffer it reads shipped leaves from and its
    own it writes new leaves to."""

    __slots__ = ("comm", "state", "inbox", "outbox")

    def __init__(self, comm: AxisComm):
        self.comm = comm
        self.state: Optional[SweepState] = None
        self.inbox: Optional[torch.Tensor] = None
        self.outbox: Optional[torch.Tensor] = None


# A rank process's step sessions by the runner's token (the rank's
# counterpart of the runners alive in the parent; ``close`` drops one).
_SESSIONS: Dict[str, _RankSession] = {}


def _point_rank(msg: tuple, token: str, n: int, device: str, deltas: bool):
    """A rank's part of one sweep point. ``msg`` is (cursor, None, ships,
    values, inbox, release) when the parent's state has the structure of
    this rank's last output (only the cursor and the shipped leaves can
    differ), else (None, skeleton, ships, values, inbox, release) with
    ``_Held``, ``_HostOnly`` or ``_SLOT`` (shipped) at each leaf;
    ``ships`` places the shipped leaves in the staging buffer ``inbox``
    (sent when new; dropped after use with ``release``), ``values`` holds
    those on the host as numpy arrays. The rank copies them out, runs one
    ``sweep_step`` over ``AxisComm``, packs the tensors
    the step made into its own staging buffer and answers the plan: each
    output leaf "new" (offset, dtype, shape), "value" (in the answer's
    values), "held" (one of its input leaves, by key; only with
    ``deltas``) or "host"; rank 0 adds the output's structure."""
    # out of the registry while the point runs: a point that raises leaves
    # no session, and the parent starts the next one afresh
    sess = _SESSIONS.pop(token, None)
    if sess is None:
        sess = _RankSession(AxisComm(rank_group(range(n))))
    comm = sess.comm
    comm.stats = StagingStats()
    dev = torch.device(device)
    cursor, skel, ships, values, inbox, release = msg
    if inbox is not None:
        sess.inbox = inbox
    # the rank's own copies: the parent rewrites its buffer at later points
    got = {k: staging_slot(sess.inbox, off, dt, shape).clone()
           for k, off, dt, shape in ships}
    got.update((k, torch.from_numpy(a)) for k, a in values.items())
    if release:
        sess.inbox = None  # the parent releases its side too
    if skel is None:
        state = replace_arrays(sess.state.replace(cursor=cursor), got)
    else:
        held = flat_arrays(sess.state) if sess.state is not None else {}
        state = replace_arrays(skel, {
            k: (held[v.key] if isinstance(v, _Held) else got.get(k, v))
            for k, v in flat_arrays(skel).items()})
    out, rep = _measured(comm, dev, lambda: sweep_step(comm, state))
    given = ({id(v): k for k, v in flat_arrays(state).items()
              if isinstance(v, torch.Tensor)} if deltas else {})
    leaves = flat_arrays(out)
    new = {k: v for k, v in leaves.items()
           if isinstance(v, torch.Tensor) and id(v) not in given}
    # a leaf on another device than the buffer's (a lane flag on the host)
    # travels by value
    values = {k: new.pop(k).numpy() for k in list(new)
              if new[k].device.type != dev.type}
    layout, nbytes = staging_layout(new)
    sess.outbox, fresh = staging_buffer(nbytes, dev, sess.outbox)
    for k, off, dt, shape in layout:
        staging_slot(sess.outbox, off, dt, shape).copy_(new[k])
    sync_device(dev)
    where = {entry[0]: entry for entry in layout}
    plan = tuple(
        (k, "new") + where[k][1:] if k in where
        else (k, "value") if k in values
        else (k, "held", given[id(v)]) if isinstance(v, torch.Tensor)
        else (k, "host")
        for k, v in leaves.items())
    sess.state = out
    _SESSIONS[token] = sess
    structure = map_state(lambda _: _SLOT, out) if comm.rank == 0 else None
    # the buffer goes to the parent when new, and again whenever the parent
    # shares a new one of its own (it starts afresh after a failed point)
    return (out.cursor, out.geom, plan, values, structure,
            sess.outbox if fresh or inbox is not None else None), rep


def _drop_session(token: str) -> None:
    if _SESSIONS.pop(token, None) is not None:
        # the session held the rank's state and buffers: hand the cached
        # blocks back to the card, which the parent and the other ranks
        # share (a no-op where CUDA was never started)
        torch.cuda.empty_cache()


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _add_reports(a: List[RankReport], b: List[RankReport]
                 ) -> List[RankReport]:
    """Rank by rank, the sums of two lists of reports (the longer list's
    extra ranks as they are)."""
    out = []
    for i in range(max(len(a), len(b))):
        if i >= len(a) or i >= len(b):
            out.append((a if i < len(a) else b)[i])
            continue
        x, y = a[i], b[i]
        out.append(RankReport(
            x.rank, x.seconds + y.seconds,
            {op: x.launches[op] + y.launches[op] for op in x.launches},
            {k: x.staged[k] + y.staged[k] for k in x.staged},
            max(x.peak_bytes, y.peak_bytes)))
    return out


class SpmdSweepStep:
    """``step(state) -> state``: one sweep point, ``sweep_step`` over
    ``AxisComm`` in each of the first ``n_slots`` ranks of ``group``, on a
    global ``SweepState`` in the ``SimComm`` layout that the caller (the
    host orchestrator) holds on the group's device.

    Deltas: each rank keeps its local state (a unit lane axis where the
    global state has P) between points. The runner sends a rank the slice
    of a leaf only when the leaf is not the object it got back at the last
    point (a fault hook, a REBUILD, a decode or a new world replaced it:
    those build new tensors), and a rank sends back only the leaves its
    ``sweep_step`` made; the runner joins those along their lane axes into
    tensors it owns. Leaves with no lane axis (the parity slots) stay in
    the parent. The leaves travel through one staging buffer a direction
    and rank, shared once (CUDA IPC on the card) and grown when too small,
    so a point's messages carry only a plan of offsets. With
    ``deltas=False`` every leaf goes both ways at every point (the
    yardstick of the round trip).

    The device is synchronised before each point (the ranks read what the
    parent's stream wrote) and after the joins (a rank rewrites its buffer
    at its next point). ``close()`` drops the ranks' sessions; ``reports``
    sums each rank's ``RankReport`` over the points and ``stats()`` gives
    the runner's own account."""

    def __init__(self, group: LaneGroup, n_slots: Optional[int] = None,
                 deltas: bool = True):
        n = group.size if n_slots is None else n_slots
        if not 2 <= n <= group.size:
            raise ValueError(f"a world of {n} slots does not fit a group of "
                             f"{group.size} ranks")
        group.subgroup(n)
        self.group, self.n, self.deltas = group, n, deltas
        self.token = uuid.uuid4().hex
        # the leaves the ranks hold (by key), and the last state returned,
        # whose structure theirs has
        self._synced: Dict[str, torch.Tensor] = {}
        self._last: Optional[SweepState] = None
        self._inbox: List[Optional[torch.Tensor]] = [None] * n
        self._outbox: List[Optional[torch.Tensor]] = [None] * n
        self._open = False
        self.points = 0
        self.seconds = 0.0       # inside the step calls
        self.rank_seconds = 0.0  # of those, waiting for the ranks
        self.leaves_shipped = self.bytes_shipped = 0
        self.leaves_returned = self.bytes_returned = 0
        self.reports: List[RankReport] = []

    def __call__(self, state: SweepState) -> SweepState:
        t0 = time.perf_counter()
        # what the ranks hold is known again only once this point succeeds
        synced, last = self._synced, self._last
        self._synced, self._last = {}, None
        device = self.group.device
        flat = flat_arrays(state)
        axes = flat_arrays(state_lane_axes(state))
        ship = {}
        for k, v in flat.items():
            ax = axes[k]
            if ax < 0 or synced.get(k) is v:
                continue
            if v.shape[ax] != self.n:
                raise ValueError(f"leaf {k} has {v.shape[ax]} lanes, the "
                                 f"world {self.n}")
            ship[k] = v
            self.leaves_shipped += 1
            self.bytes_shipped += _nbytes(v)
        shipped = set(ship)
        # leaves on the host (lane flags) go by value, the rest through the
        # staging buffers
        values = [{} for _ in range(self.n)]
        for k in [k for k, v in ship.items() if v.device.type != device.type]:
            v = ship.pop(k)
            for r in range(self.n):
                values[r][k] = v.narrow(axes[k], r, 1).numpy()
        layout, nbytes = staging_layout(
            {k: v.narrow(axes[k], 0, 1) for k, v in ship.items()})
        fresh = []
        for r in range(self.n):
            self._inbox[r], new_buf = staging_buffer(nbytes, device, self._inbox[r])
            fresh.append(new_buf)
            for k, off, dt, shape in layout:
                staging_slot(self._inbox[r], off, dt, shape).copy_(
                    ship[k].narrow(axes[k], r, 1))
        if (last is not None and state.geom == last.geom
                and flat.keys() == flat_arrays(last).keys()):
            cursor, skel = state.cursor, None
        else:
            cursor, skel = None, replace_arrays(state, {
                k: (_HostOnly() if axes[k] < 0 else _SLOT if k in shipped
                    else _Held(k)) for k in flat})
        release = nbytes > _STAGING_KEEP
        sync_device(device)
        self._open = True
        t1 = time.perf_counter()
        try:
            outs = self.group.run(
                _point_rank, self.token, self.n, str(device), self.deltas,
                each=[((cursor, skel, layout, values[r],
                        self._inbox[r] if fresh[r] else None, release),)
                      for r in range(self.n)], ranks=self.n)
        except BaseException:
            # a rank that raised dropped its session: share new buffers
            self._inbox = [None] * self.n
            self._outbox = [None] * self.n
            raise
        self.rank_seconds += time.perf_counter() - t1
        if release:
            self._inbox = [None] * self.n  # as the ranks dropped theirs
        self.reports = _add_reports(self.reports, [rep for _, rep in outs])
        answers = [a for a, _ in outs]
        if any(a[:3] != answers[0][:3] for a in answers[1:]):
            raise RankError("the ranks' cursors, geometries or plans differ: "
                            f"{[a[:2] for a in answers]}")
        for r, a in enumerate(answers):
            if a[5] is not None:
                self._outbox[r] = a[5]
        structure = answers[0][4]
        out_axes = flat_arrays(state_lane_axes(structure))
        new: Dict[str, Any] = {}
        for k, kind, *rest in answers[0][2]:
            if kind in ("new", "value"):
                new[k] = torch.cat(
                    [staging_slot(box, *rest) for box in self._outbox]
                    if kind == "new" else
                    [torch.from_numpy(a[3][k]) for a in answers],
                    dim=out_axes[k])
                self.leaves_returned += 1
                self.bytes_returned += _nbytes(new[k])
            else:
                new[k] = flat[rest[0] if kind == "held" else k]
        # the joins read the ranks' buffers before their next point rewrites
        # them
        sync_device(device)
        out = replace_arrays(structure, new)
        if self.deltas:
            self._synced = {k: v for k, v in new.items() if out_axes[k] >= 0}
        self._last = out
        self.points += 1
        self.seconds += time.perf_counter() - t0
        return out

    def stats(self) -> Dict[str, Any]:
        """Points run, seconds inside the step calls and of those waiting
        for the ranks, leaves and bytes shipped to the ranks and joined
        from their answers (bytes of the global leaves)."""
        return dict(n_slots=self.n, deltas=self.deltas, points=self.points,
                    seconds=self.seconds, rank_seconds=self.rank_seconds,
                    leaves_shipped=self.leaves_shipped,
                    bytes_shipped=self.bytes_shipped,
                    leaves_returned=self.leaves_returned,
                    bytes_returned=self.bytes_returned)

    def close(self) -> None:
        """Drop the ranks' sessions (their local states and buffers)."""
        if self._open and not self.group.closed:
            self.group.run(_drop_session, self.token, ranks=self.n)
        self._open = False
        self._synced, self._last = {}, None
        self._inbox = [None] * self.n
        self._outbox = [None] * self.n


def make_spmd_sweep_step(group: LaneGroup) -> SpmdSweepStep:
    """The orchestrator's per-point runner over every rank of ``group``
    (``SweepOrchestrator(..., step_fn=...)``): the counterpart of the
    reference's shard_map segment backend, with a lane group in place of a
    mesh. Close it when done (the entries do)."""
    return SpmdSweepStep(group)


def make_spmd_step_factory(group: LaneGroup
                           ) -> Callable[[int], SpmdSweepStep]:
    """The elastic orchestrator's runner factory: ``factory(n_slots)`` is a
    ``SpmdSweepStep`` over a gloo subgroup of the first ``n_slots`` ranks
    (no rank is spawned; the ranks outside wait). Making a runner closes
    the ones made before, whose world has ended; ``factory.runners`` lists
    every runner made, for their accounts and the final ``close``."""
    runners: List[SpmdSweepStep] = []

    def factory(n_slots: int) -> SpmdSweepStep:
        for r in runners:
            r.close()
        runners.append(SpmdSweepStep(group, n_slots))
        return runners[-1]

    factory.runners = runners
    return factory


def _sweep_online(A, panel_width: int, detector, group: Optional[LaneGroup],
                  device, kw: dict):
    from repro_torch.ft.online.orchestrator import SweepOrchestrator

    own = group is None
    if own:
        group = make_lane_group(device=device)
    factory = make_spmd_step_factory(group)
    try:
        A = torch.as_tensor(np.asarray(A) if isinstance(A, np.ndarray)
                            else A).to(group.device)
        m, n = A.shape
        P = group.size
        if m % P:
            raise ValueError(f"rows ({m}) must block-shard evenly over {P} "
                             "lanes")
        orch = SweepOrchestrator(
            A.reshape(P, m // P, n), SimComm(P), panel_width,
            detector=detector, step_fn=factory(P), step_factory=factory,
            **kw)
        # the result is the parent's own: the orchestrator assembles it
        # from the joined global state
        return orch.run()
    finally:
        for r in factory.runners:
            r.close()
        reports: List[RankReport] = []
        for r in factory.runners:
            reports = _add_reports(reports, r.reports)
        group.last_reports = reports
        group.last_steps = dict(
            worlds=[r.n for r in factory.runners],
            **{k: sum(r.stats()[k] for r in factory.runners)
               for k in ("points", "seconds", "rank_seconds",
                         "leaves_shipped", "bytes_shipped",
                         "leaves_returned", "bytes_returned")})
        if own:
            group.close()


def ft_caqr_sweep_online_spmd(A, panel_width: int, detector=None,
                              group: Optional[LaneGroup] = None,
                              device="cuda", **orchestrator_kw
                              ) -> FTSweepResult:
    """Online recovery with one process per lane: the host orchestrator
    (``SweepOrchestrator``) in this process, one ``sweep_step`` a segment
    point in every rank, deaths discovered at runtime between points.

    ``A`` is the whole ``(m, n)`` matrix, row-sharded over the ranks like
    ``ft_caqr_sweep_spmd``. The parent holds the global state on the
    group's device in the ``SimComm`` layout; detection, fault hooks,
    REBUILD, the ``MDSScheme`` refresh (encoded here on the global state,
    as the reference's host does between shard_map segments), the store
    and elastic transitions all run there, on the state the ranks' points
    leave. Extra keywords (``fault_hooks``, ``segment_points``, ``scheme``,
    ``store``, ``async_segments``, ...) go to the orchestrator; ``fused``
    is refused with a runner, as in the reference. ``group=None`` spawns
    ``make_lane_group(device=device)`` for this call (raises without CUDA
    unless ``device="cpu"``). The result is in the ``SimComm`` layout, in
    tensors the caller owns; ``group.last_reports`` sums each rank's
    reports over the run and ``group.last_steps`` the runners' accounts."""
    return _sweep_online(A, panel_width, detector, group, device,
                         orchestrator_kw)


def ft_caqr_sweep_elastic_spmd(A, panel_width: int, detector=None,
                               group: Optional[LaneGroup] = None,
                               semantics=None, device="cuda",
                               **orchestrator_kw):
    """``ft_caqr_sweep_online_spmd`` with SHRINK (default) or BLANK
    semantics: a detected death is healed from its buddies and, at the
    next panel boundary, the sweep re-meshes onto a gloo subgroup of the
    first ranks under the fold policy (the floor power of two of the
    survivors, rows re-split evenly). Returns an ``ElasticSweepResult``."""
    return _sweep_online(A, panel_width, detector, group, device, dict(
        orchestrator_kw,
        semantics=Semantics.SHRINK if semantics is None else semantics,
        elastic_policy="fold"))
