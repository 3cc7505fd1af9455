"""The P-lane communication layout (port of ``src/repro/core/comm.py``,
``SimComm`` only).

Every per-lane array carries a leading lane axis P. On one GPU this is the
production layout, not a simulator: a lane-batched call runs the lanes as
one kernel launch. ``ppermute`` restacks the lane slices, and the
death-mask primitives (``where_lane``, ``poison``, ``fetch_lane``) are
indexing on the lane axis. ``AxisComm``, ``xor_reduce`` and ``lane_slice``
are not ported yet.

Lane-dependent bookkeeping (``axis_index`` and conditions built from it)
lives on the CPU; ``where`` moves a condition to the data's device
without blocking on the stream.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from repro_torch.kernels.backend import to_device


def _as_tensor(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, device=dev)


class SimComm:
    """P lanes on one device: per-lane arrays carry a leading P axis."""

    def __init__(self, P: int):
        self.P = P

    def axis_size(self) -> int:
        return self.P

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
        a = _as_tensor(a, b)
        b = _as_tensor(b, a)
        cond = to_device(cond, a.device)
        ndim = max(a.dim(), b.dim())
        if cond.dim() < ndim:
            cond = cond.reshape(tuple(cond.shape) + (1,) * (ndim - cond.dim()))
        return torch.where(cond, a, b)

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
