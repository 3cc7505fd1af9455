"""Task planning (port of ``src/repro/train/ftrun/tasks.py``): which
optimizer-internal factorizations go through the FT-QR engine, and how
tree leaves map onto 2-D sweeps.

One :class:`QRTask` per 2-D factorization the optimizer needs every
step. Stacked leaves (layer groups ``(G, m, n)``) are split per leading
slice; wide slices are transposed for Muon (orthogonalize the short
side). Leaves whose 2-D slice has fewer than ``min_qr_size`` elements
stay on the optimizer's own TSQR chain. Paths are ``repro_torch.tree``
path strings, so the plans equal the JAX package's name for name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.optim.caqr_muon import _is_muon


@dataclasses.dataclass(frozen=True)
class QRTask:
    """One optimizer-internal factorization: ``name`` is ``path`` for 2-D
    leaves, ``path#i`` for slice ``i`` of a stacked leaf. ``rows/cols`` is
    the tall orientation swept (``transpose`` records the flip)."""

    name: str
    path: str
    index: Optional[int]      # leading-slice index, None for 2-D leaves
    rows: int
    cols: int
    transpose: bool


def _leaf_tasks(path: str, leaf: torch.Tensor) -> List[QRTask]:
    m, n = int(leaf.shape[-2]), int(leaf.shape[-1])
    rows, cols = (m, n) if m >= n else (n, m)
    transpose = m < n
    if leaf.dim() == 2:
        return [QRTask(path, path, None, rows, cols, transpose)]
    lead = math.prod(leaf.shape[:-2])
    return [QRTask(f"{path}#{i}", path, i, rows, cols, transpose)
            for i in range(lead)]


def plan_muon_tasks(params, min_qr_size: int = 8192) -> List[QRTask]:
    """Tasks for ``caqr_muon``: every Muon-eligible leaf whose per-slice
    size is at least ``min_qr_size`` elements."""
    tasks: List[QRTask] = []
    for path, p in tree.flatten_with_path(params):
        if not _is_muon(path, p):
            continue
        if int(p.shape[-2]) * int(p.shape[-1]) < min_qr_size:
            continue
        tasks.extend(_leaf_tasks(path, p))
    return tasks


def plan_psgd_tasks(params, min_size: int = 8192) -> List[QRTask]:
    """Tasks for the PowerSGD bridge: 2-D-sliceable leaves big enough to
    compress, untransposed (the engine sweeps the tall ``(m, r)``
    projection; rows/cols describe the slice)."""
    tasks: List[QRTask] = []
    for ps, p in tree.flatten_with_path(params):
        if p.dim() < 2:
            continue
        m, n = int(p.shape[-2]), int(p.shape[-1])
        if m * n < min_size or m < 2 or n < 2:
            continue
        if p.dim() == 2:
            tasks.append(QRTask(ps, ps, None, m, n, False))
        else:
            lead = math.prod(p.shape[:-2])
            tasks.extend(QRTask(f"{ps}#{i}", ps, i, m, n, False)
                         for i in range(lead))
    return tasks


def leaf_by_path(t, path: str):
    """Navigate a tree by a ``/``-joined path: dict keys, sequence
    indices and ``.attr`` components for NamedTuple nodes."""
    node = t
    for k in path.split("/"):
        if k.startswith("."):
            node = getattr(node, k[1:])
        elif isinstance(node, (list, tuple)):
            node = node[int(k)]
        else:
            node = node[k]
    return node


def task_slice(t, task: QRTask) -> torch.Tensor:
    """The 2-D matrix a task factorizes, in its original orientation (the
    engine handles the tall flip)."""
    leaf = leaf_by_path(t, task.path)
    if task.index is None:
        return leaf
    return leaf.reshape((-1,) + tuple(leaf.shape[-2:]))[task.index]


def assemble_leaves(t, per_task: Dict[str, torch.Tensor],
                    tasks: List[QRTask]) -> Dict[str, torch.Tensor]:
    """Per-task 2-D results as full leaf-shaped tensors keyed by leaf
    path (slice results stacked back into the leading axes)."""
    by_path: Dict[str, List[Tuple[int, torch.Tensor]]] = {}
    for tk in tasks:
        by_path.setdefault(tk.path, []).append(
            (tk.index if tk.index is not None else 0, per_task[tk.name]))
    out: Dict[str, torch.Tensor] = {}
    for path, pieces in by_path.items():
        leaf = leaf_by_path(t, path)
        if len(pieces) == 1 and pieces[0][0] == 0 and leaf.dim() == 2:
            out[path] = pieces[0][1]
            continue
        pieces.sort(key=lambda p: p[0])
        out[path] = torch.stack([q for _, q in pieces]).reshape(leaf.shape)
    return out
