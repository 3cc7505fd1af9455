"""Diskless checkpointing (port of ``src/repro/ckpt/diskless.py``).

* ``BuddyStore``: each lane keeps a full host-memory replica of its
  XOR buddy's state; recovering one lane is one fetch from its buddy.
* ``ParityStore``: groups of g lanes keep an XOR parity of the bitwise
  float representations; any single loss in a group is rebuilt from the
  g-1 survivors plus the parity.
* ``SweepStateStore``: host-memory snapshots of an in-flight FT-CAQR sweep
  that the online orchestrator pushes at its boundaries, so a successor
  can restore the last boundary state and resume.

States are trees (dicts, lists, tuples) of tensors or numpy arrays, kept on
the host as numpy arrays (bfloat16 tensors as float32).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, lists and tuples
    (NamedTuples keep their type), with the matching leaves of ``rest``."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, *xs) for xs in zip(tree, *rest)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        # numpy has no bfloat16: widen to float32, which is exact (the
        # restoring side narrows back to its template's dtype)
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _to_host(tree) -> Any:
    return _tree_map(_host, tree)


def _xor_trees(a, b):
    def x(u, v):
        ub = u.view(np.uint8) if u.dtype != np.uint8 else u
        vb = v.view(np.uint8) if v.dtype != np.uint8 else v
        return (ub ^ vb).view(u.dtype)

    return _tree_map(x, a, b)


class BuddyStore:
    """Full replica on the XOR(1)-buddy lane."""

    def __init__(self, n_lanes: int):
        assert n_lanes % 2 == 0
        self.n = n_lanes
        self._store: Dict[int, Any] = {}

    def buddy(self, lane: int) -> int:
        return lane ^ 1

    def push(self, lane: int, state) -> None:
        """Lane ``lane`` ships its state to its buddy's memory."""
        self._store[self.buddy(lane)] = _to_host(state)

    def recover(self, failed: int) -> Any:
        """The failed lane's state, read from ONE surviving store: the
        replica in its buddy's memory."""
        holder = self.buddy(failed)
        assert holder in self._store, f"lane {holder} holds no replica"
        return self._store[holder]


class SweepStateStore:
    """Diskless host-memory snapshots of an in-flight FT-CAQR sweep. The
    online orchestrator pushes the live ``SweepState`` every
    ``persist_every`` boundaries; a successor restores the last one and
    resumes. Keeps the ``keep`` most recent snapshots. ``version`` is the
    wire format (v2, the default, carries the coded parity slots).
    ``restore`` puts the tensors back on the device they were pushed from
    unless given another."""

    def __init__(self, keep: int = 2, version: Optional[int] = None):
        from repro_torch.ft.online.state import WIRE_VERSION

        assert keep >= 1
        self.keep = keep
        self.version = WIRE_VERSION if version is None else version
        self._snaps: List[Tuple[Dict[str, np.ndarray], torch.device]] = []

    def push(self, state) -> None:
        from repro_torch.ft.online.state import sweep_state_to_host

        self._snaps.append((sweep_state_to_host(state, version=self.version),
                            state.A.device))
        del self._snaps[: -self.keep]

    def __len__(self) -> int:
        return len(self._snaps)

    def restore(self, back: int = 0, device=None):
        """Rebuild the ``back``-th most recent snapshot (0 = latest)."""
        from repro_torch.ft.online.state import sweep_state_from_host

        assert self._snaps, "no snapshot pushed"
        arrays, pushed_from = self._snaps[-1 - back]
        return sweep_state_from_host(
            arrays, device=pushed_from if device is None else device)


class ParityStore:
    """XOR parity per group of ``group`` lanes."""

    def __init__(self, n_lanes: int, group: int = 4):
        assert n_lanes % group == 0
        self.n = n_lanes
        self.g = group
        self._parity: Dict[int, Any] = {}
        self._shards: Dict[int, Any] = {}

    def push_group(self, states: List[Any]) -> None:
        """Checkpoint all lanes (at a checkpoint step)."""
        assert len(states) == self.n
        self._shards = {i: _to_host(s) for i, s in enumerate(states)}
        for g0 in range(0, self.n, self.g):
            parity = self._shards[g0]
            for i in range(g0 + 1, g0 + self.g):
                parity = _xor_trees(parity, self._shards[i])
            self._parity[g0 // self.g] = parity

    def recover(self, failed: int) -> Any:
        """Rebuild from the g-1 survivors plus the group parity."""
        g0 = (failed // self.g) * self.g
        acc = self._parity[failed // self.g]
        for i in range(g0, g0 + self.g):
            if i != failed:
                acc = _xor_trees(acc, self._shards[i])
        return acc
