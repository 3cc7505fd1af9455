"""One process per lane: the FT-CAQR sweep across the ranks of a
``torch.distributed`` group (port of ``src/repro/launch/spmd_qr.py``, its
scheduled half; paper §II's execution model).

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

The online and elastic SPMD entries (the reference's
``make_spmd_sweep_step`` and what follows it) are not ported yet.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import time
import traceback
import weakref
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.caqr import CAQRResult, PanelFactors, caqr_factorize_spmd
from repro_torch.core.comm import AxisComm, axis_comm, lane_block
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
from repro_torch.ft.online.state import initial_sweep_state, run_steps
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
    at the task's start), and its ``AxisComm``'s staging statistics."""

    rank: int
    seconds: float
    launches: Dict[str, int]
    staged: Dict[str, float]


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
        self.closed = False
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

    def run(self, fn: Callable, *args, each: Optional[Sequence[tuple]] = None
            ) -> List[Any]:
        """``fn(*each[r], *args)`` in rank r (``fn(*args)`` without
        ``each``); the results in rank order. Raises what a rank raised
        (same type where it can be re-created, with the rank's message and
        traceback), or ``RankError`` when a rank died or the task outlasted
        the group's timeout; the group is then closed."""
        if self.closed:
            raise RuntimeError("the lane group is closed")
        # a queue pickles in a background thread and only prints what fails
        # there, so check here that the ranks can import the function
        pickle.dumps(fn)
        for r, q in enumerate(self._tasks):
            q.put((fn, tuple(each[r] if each is not None else ()) + args))
        return self._collect("ok")

    def _collect(self, kind: str) -> List[Any]:
        got: Dict[int, tuple] = {}
        dead_since: Dict[int, float] = {}
        now = time.monotonic()
        deadline = now + self.timeout_s
        while len(got) < self.size:
            now = time.monotonic()
            if now >= deadline:
                break
            try:
                rank, what, val = self._results.get(
                    timeout=min(0.5, deadline - now))
            except queue.Empty:
                # a rank that exited may still have a report in the pipe
                for r, p in enumerate(self._procs):
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
        silent = [r for r in range(self.size) if r not in got]
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
        return [got[r][1] for r in range(self.size)]


def make_lane_group(n_lanes: Optional[int] = None, device="cuda",
                    timeout_s: float = 120.0) -> LaneGroup:
    """Spawn ``n_lanes`` ranks (a power of two; default ``pow2_lanes()``)
    in one gloo group on ``device`` (the card by default; raises without
    CUDA unless ``device="cpu"``). On the card, build the kernels first
    (``repro_torch.kernels.build.build_all()``): the ranks load the built
    libraries and start no nvcc. The counterpart of the reference's
    ``make_lane_mesh``."""
    return LaneGroup(pow2_lanes() if n_lanes is None else n_lanes, device,
                     timeout_s)


# -- rank bodies ---------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measured(comm: AxisComm, device: torch.device, body: Callable):
    """``(body(), RankReport)``: seconds, launches and staging of one
    rank body."""
    before = dict(backend.LAUNCHES)
    _sync(device)
    t0 = time.perf_counter()
    out = body()
    _sync(device)
    seconds = time.perf_counter() - t0
    launches = {op: backend.LAUNCHES[op] - before[op] for op in backend.OPS}
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
