"""Communication abstraction: one lane-batched code path, two executions
(port of ``src/repro/core/comm.py``).

``SimComm``  -- P lanes in one process: every per-lane array carries a
leading lane axis P. On one GPU this is the production layout, not a
simulator: a lane-batched call runs the lanes as one kernel launch.
``ppermute`` restacks the lane slices, and the death-mask primitives
(``where_lane``, ``poison``, ``fetch_lane``) are indexing on the lane
axis.

``AxisComm`` -- one lane a process (a rank of a ``torch.distributed``
group, the paper's execution model). Its local arrays keep a UNIT lane
axis where ``SimComm``'s carry P, so the lane-batched core code and the
K1-K4 launches run unchanged, one lane a rank. Every exchange is a
collective of the group: ``ppermute`` one ``batch_isend_irecv`` round,
``psum`` and ``xor_reduce`` an ``all_gather`` reduced in lane order (so
the sum's bits equal ``SimComm``'s), and ``fetch_lane``/``recv_lane`` one
point-to-point transfer in which only the source sends. Gloo carries host
tensors only, so CUDA data is staged through pinned host buffers.

Both comms give ``xor_reduce`` (the parity collective of
``repro_torch.ft.coding``), ``lane_slice`` (one lane's slice; under
``AxisComm`` only on that lane), ``local_lanes`` (how many lanes a local
array holds: P or 1; shapes are sized by it, the butterfly by
``axis_size``) and ``holds`` (whether this process computes a lane's
one-lane replay). Rules for code written against both: every rank runs
the same program and enters every collective in the same order; a
one-lane replay (``repro_torch.ft.driver``) computes only where
``holds(lane)`` and reads other lanes through ``recv_lane``.

Lane-dependent bookkeeping (``axis_index`` and conditions built from it)
lives on the CPU; ``where`` moves a condition to the data's device
without blocking on the stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.backend import to_device


def _as_tensor(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, device=dev)


def _where(cond, a, b):
    """``torch.where`` with a per-lane ``cond`` broadcast over the trailing
    axes (both comms' ``where``)."""
    a = _as_tensor(a, b)
    b = _as_tensor(b, a)
    cond = to_device(cond, a.device)
    ndim = max(a.dim(), b.dim())
    if cond.dim() < ndim:
        cond = cond.reshape(tuple(cond.shape) + (1,) * (ndim - cond.dim()))
    return torch.where(cond, a, b)


class SimComm:
    """P lanes on one device: per-lane arrays carry a leading P axis."""

    def __init__(self, P: int):
        self.P = P

    def axis_size(self) -> int:
        return self.P

    def local_lanes(self) -> int:
        """Lanes a local array holds: all P."""
        return self.P

    def holds(self, lane: int) -> bool:
        """Whether this process computes ``lane``'s one-lane work: every
        lane lives here."""
        return True

    def axis_index(self) -> torch.Tensor:
        return torch.arange(self.P, dtype=torch.int32)

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]):
        """Lane ``dst`` gets lane ``src``'s slice for each pair; lanes that
        receive nothing get zeros (``lax.ppermute`` semantics)."""
        src = [-1] * self.P
        for s, d in perm:
            src[d] = s
        zero = torch.zeros_like(x[0])
        return torch.stack([x[s] if s >= 0 else zero for s in src])

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x, dim=0, keepdim=True).expand(x.shape).contiguous()

    def where(self, cond, a, b):
        """``torch.where`` with a per-lane ``cond`` broadcast over the
        trailing axes of ``a`` and ``b``."""
        return _where(cond, a, b)

    def map_local(self, fn: Callable) -> Callable:
        """Per-lane functions of the port are written lane-batched (the lane
        axis is a kernel grid dimension), so they apply as they are."""
        return fn

    def local_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)[1:]

    # -- death-mask primitives ---------------------------------------------

    def _lane_index(self, lane: int, lane_axis: int) -> Tuple:
        return (slice(None),) * lane_axis + (lane,)

    def where_lane(self, lane: int, a, b, lane_axis: int = 0):
        """Lane ``lane`` sees ``a``; every other lane sees ``b``."""
        a = _as_tensor(a, b)
        b = _as_tensor(b, a)
        ndim = max(a.dim(), b.dim())
        cond = (torch.arange(self.P, device=a.device) == lane).reshape(
            (1,) * lane_axis + (self.P,) + (1,) * (ndim - lane_axis - 1))
        return torch.where(cond, a, b)

    def poison(self, x: torch.Tensor, lane: int, lane_axis: int = 0):
        """Mask-based process death: NaN lane ``lane``'s slice (float
        tensors only)."""
        if not x.is_floating_point():
            return x
        out = x.clone()
        out[self._lane_index(lane, lane_axis)] = float("nan")
        return out

    def fetch_lane(self, x: torch.Tensor, dst: int, src: int,
                   lane_axis: int = 0, into=None):
        """Single-source REBUILD fetch: lane ``dst``'s slot of ``into``
        (default ``x``) becomes lane ``src``'s slice of ``x``."""
        out = (x if into is None else into).clone()
        out[self._lane_index(dst, lane_axis)] = x[self._lane_index(src, lane_axis)]
        return out

    def recv_lane(self, x: torch.Tensor, dst: int, src: int,
                  lane_axis: int = 0) -> torch.Tensor:
        """Lane ``src``'s slice of ``x`` as lane ``dst`` reads it (a view):
        the one-lane replay's single-source read."""
        return x.select(lane_axis, src)

    def xor_reduce(self, x: torch.Tensor, lane_axis: int = 0) -> torch.Tensor:
        """Bitwise-XOR reduction of an integer tensor over the lane axis
        (the parity collective of ``repro_torch.ft.coding``). The lane axis
        is reduced away: the parity is a checksum-lane value with no
        per-lane copy."""
        x = torch.movedim(x, lane_axis, 0)
        out = x[0].clone()
        for i in range(1, x.shape[0]):
            out.bitwise_xor_(x[i])
        return out

    def lane_slice(self, x: torch.Tensor, lane: int, lane_axis: int = 0):
        """One lane's slice of a batched tensor (a view). The orchestrator's
        speculative straggler recompute compares a rebuilt lane slice with
        the original through it."""
        return x[self._lane_index(lane, lane_axis)]


# -- one lane a process ------------------------------------------------------


def axis_comm(group=None) -> "AxisComm":
    """``group`` itself if it is an ``AxisComm``, else an ``AxisComm`` over
    that process group (None: the default group)."""
    return group if isinstance(group, AxisComm) else AxisComm(group)


def lane_block(A_local: torch.Tensor) -> torch.Tensor:
    """A rank's block with its unit lane axis: ``(m_loc, n)`` gains it,
    ``(1, m_loc, n)`` is returned as it is."""
    return A_local.unsqueeze(0) if A_local.dim() == 2 else A_local


@dataclasses.dataclass
class StagingStats:
    """What an ``AxisComm`` moved: collectives entered, bytes copied from
    the device to host buffers and back (0 for CPU data), bytes handed to
    and taken from the transport, seconds inside the collectives (staging
    included), and of those the seconds spent waiting for this process's
    own queued kernels to finish before the first copy to the host."""

    collectives: int = 0
    bytes_d2h: int = 0
    bytes_h2d: int = 0
    bytes_sent: int = 0
    bytes_received: int = 0
    seconds: float = 0.0
    device_wait_seconds: float = 0.0


class AxisComm:
    """One lane a process over a ``torch.distributed`` process group
    (default: the default group). Local arrays carry a unit lane axis; the
    lane is the group rank. Gloo carries only host tensors, so CUDA data
    goes through pinned host buffers in both directions; ``stats`` counts
    what was staged."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.P = dist.get_world_size(group)
        self.stats = StagingStats()

    def axis_size(self) -> int:
        return self.P

    def local_lanes(self) -> int:
        """Lanes a local array holds: one."""
        return 1

    def holds(self, lane: int) -> bool:
        return lane == self.rank

    def axis_index(self) -> torch.Tensor:
        return torch.tensor([self.rank], dtype=torch.int32)

    def local_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return tuple(x.shape)[1:]

    def map_local(self, fn: Callable) -> Callable:
        return fn

    def where(self, cond, a, b):
        return _where(cond, a, b)

    # -- transport ---------------------------------------------------------

    def _peer(self, lane: int) -> int:
        if self.group is None:
            return lane
        return self._dist.get_global_rank(self.group, lane)

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous host copy of ``x`` to send (pinned for CUDA data)."""
        if x.device.type == "cpu":
            return x.contiguous()
        # the copy waits for the stream anyway; draining it first splits
        # that wait from the transfer
        t0 = time.perf_counter()
        torch.cuda.current_stream(x.device).synchronize()
        self.stats.device_wait_seconds += time.perf_counter() - t0
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        self.stats.bytes_d2h += h.numel() * h.element_size()
        return h

    def _buffer(self, like: torch.Tensor) -> torch.Tensor:
        """A host buffer to receive a tensor shaped like ``like`` into."""
        return torch.empty(like.shape, dtype=like.dtype,
                           pin_memory=like.device.type == "cuda")

    def _back(self, h: torch.Tensor, device: torch.device) -> torch.Tensor:
        if device.type == "cpu":
            return h
        self.stats.bytes_h2d += h.numel() * h.element_size()
        return h.to(device, non_blocking=True)

    def _exchange(self, sends: List[Tuple[torch.Tensor, int]],
                  recvs: List[Tuple[torch.Tensor, int]]) -> None:
        """One ``batch_isend_irecv`` round: ``(host tensor, lane)`` pairs."""
        dist = self._dist
        ops = [dist.P2POp(dist.isend, h, self._peer(l), self.group)
               for h, l in sends]
        ops += [dist.P2POp(dist.irecv, h, self._peer(l), self.group)
                for h, l in recvs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.stats.bytes_sent += sum(h.numel() * h.element_size()
                                     for h, _ in sends)
        self.stats.bytes_received += sum(h.numel() * h.element_size()
                                         for h, _ in recvs)

    def _gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every lane's ``x`` on the host, in lane order (one all_gather)."""
        h = self._host(x)
        out = [torch.empty(h.shape, dtype=h.dtype, pin_memory=h.is_pinned())
               for _ in range(self.P)]
        self._dist.all_gather(out, h, group=self.group)
        n = h.numel() * h.element_size()
        self.stats.bytes_sent += n
        self.stats.bytes_received += n * (self.P - 1)
        return out

    def _timed(self, t0: float) -> None:
        self.stats.collectives += 1
        self.stats.seconds += time.perf_counter() - t0

    # -- collectives -------------------------------------------------------

    def ppermute(self, x: torch.Tensor, perm: Sequence[Tuple[int, int]]):
        """Lane ``dst`` gets lane ``src``'s value for each pair; a lane that
        receives nothing gets zeros (``lax.ppermute`` semantics)."""
        t0 = time.perf_counter()
        sends = [d for s, d in perm if s == self.rank]
        srcs = [s for s, d in perm if d == self.rank]
        assert len(srcs) <= 1, f"lane {self.rank} receives twice in {perm}"
        h = self._host(x) if sends else None
        buf = self._buffer(x) if srcs else None
        self._exchange([(h, d) for d in sends],
                       [(buf, s) for s in srcs])
        out = (self._back(buf, x.device) if srcs else torch.zeros_like(x))
        self._timed(t0)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over lanes, on every lane: the lanes' values gathered
        into ``SimComm``'s (P, ...) layout and summed there, so the bits
        equal the single-process sum on the same device."""
        t0 = time.perf_counter()
        parts = self._gather(x)
        full = torch.cat([self._back(h, x.device) for h in parts])
        out = torch.sum(full, dim=0, keepdim=True)
        self._timed(t0)
        return out

    def xor_reduce(self, x: torch.Tensor, lane_axis: int = 0) -> torch.Tensor:
        """Bitwise-XOR reduction of an integer tensor over the lanes, the
        unit lane axis reduced away; every lane holds the result. One
        ``all_reduce(op=BXOR)`` on a host copy: XOR is exact and
        associative, so the bytes do not depend on the reduction order."""
        t0 = time.perf_counter()
        x0 = x.select(lane_axis, 0)
        # the reduction runs in place: a CPU value is copied first
        h = x0.clone(memory_format=torch.contiguous_format) \
            if x0.device.type == "cpu" else self._host(x0)
        self._dist.all_reduce(h, op=self._dist.ReduceOp.BXOR,
                              group=self.group)
        n = h.numel() * h.element_size()
        self.stats.bytes_sent += n
        self.stats.bytes_received += n
        out = self._back(h, x.device)
        self._timed(t0)
        return out

    # -- death-mask primitives ---------------------------------------------

    def where_lane(self, lane: int, a, b, lane_axis: int = 0):
        """Lane ``lane`` sees ``a`` (broadcast to ``b``'s shape, a copy);
        every other lane sees ``b``. A pure select: ``a`` may be None where
        this process does not hold ``lane`` (a value only the lane
        computes)."""
        if lane != self.rank:
            return _as_tensor(b, a)
        a = _as_tensor(a, b)
        return a.expand_as(_as_tensor(b, a)).clone()

    def poison(self, x: torch.Tensor, lane: int, lane_axis: int = 0):
        """Mask-based process death: NaN the whole local value on lane
        ``lane`` (float tensors only)."""
        if not x.is_floating_point() or lane != self.rank:
            return x
        return torch.full_like(x, float("nan"))

    def fetch_lane(self, x: torch.Tensor, dst: int, src: int,
                   lane_axis: int = 0, into=None):
        """Single-source REBUILD fetch: lane ``dst``'s value of ``into``
        (default ``x``) becomes lane ``src``'s value of ``x``; every other
        lane keeps ``into``. One point-to-point transfer: only ``src``
        sends, only ``dst`` receives."""
        into = x if into is None else into
        got = self._p2p(x, dst, src)
        return into if got is None else got

    def recv_lane(self, x: torch.Tensor, dst: int, src: int,
                  lane_axis: int = 0) -> Optional[torch.Tensor]:
        """Lane ``src``'s slice of ``x`` (the unit lane axis dropped) at
        lane ``dst``; None on every other lane. One point-to-point
        transfer."""
        return self._p2p(x.select(lane_axis, 0), dst, src)

    def _p2p(self, x: torch.Tensor, dst: int, src: int):
        assert src != dst, (src, dst)
        if self.rank not in (src, dst):
            return None
        t0 = time.perf_counter()
        if self.rank == src:
            self._exchange([(self._host(x), dst)], [])
            out = None
        else:
            buf = self._buffer(x)
            self._exchange([], [(buf, src)])
            out = self._back(buf, x.device)
        self._timed(t0)
        return out

    def lane_slice(self, x: torch.Tensor, lane: int, lane_axis: int = 0):
        """This lane's slice (a view); valid only on lane ``lane`` itself,
        since no process holds another lane's data."""
        if lane != self.rank:
            raise ValueError(f"lane {self.rank} cannot slice lane {lane}: "
                             "only the lane itself holds its data")
        return x.select(lane_axis, 0)
