"""``NamedSharding`` trees for parameters, optimizer state, batches and
caches (port of ``src/repro/dist/params_sharding.py``).

Parameters and optimizer state take an FSDP layout: each leaf is split
along its largest dimension divisible by the FSDP axes' size (replicated
when none divides: norms, scalars). Batches split their leading (batch)
dimension; decode caches their batch and, optionally, the KV sequence
dimension.

Every function takes a tree whose leaves have a ``shape`` (tensors, on
the meta device too) and returns the tree of ``NamedSharding`` with the
same structure; the specs are the reference's, leaf for leaf.
"""
from __future__ import annotations

import math
from typing import Any, Sequence, Union

import torch

from repro_torch import tree
from repro_torch.dist.compat import Mesh, PartitionSpec as P, spec_axes

Axes = Union[None, str, Sequence[str]]


class NamedSharding:
    """A spec on a mesh (the counterpart of ``jax.sharding.NamedSharding``):
    ``shard_shape`` gives a device's block shape, ``block`` a device's
    block of a tensor and ``assemble`` the tensor from every device's."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, spec

    def _parts(self, d: int) -> int:
        if d >= len(self.spec):
            return 1
        return math.prod(self.mesh.shape[a] for a in spec_axes(self.spec[d]))

    def shard_shape(self, global_shape: Sequence[int]) -> tuple:
        out = []
        for d, n in enumerate(global_shape):
            k = self._parts(d)
            if n % k:
                raise ValueError(f"dimension {d} of {tuple(global_shape)} "
                                 f"does not split over {self.spec[d]!r} ({k})")
            out.append(n // k)
        return tuple(out)

    def _index(self, d: int, coord) -> int:
        names = self.mesh.axis_names
        idx = 0
        for a in spec_axes(self.spec[d]) if d < len(self.spec) else ():
            idx = idx * self.mesh.shape[a] + int(coord[names.index(a)])
        return idx

    def block(self, x: torch.Tensor, coord) -> torch.Tensor:
        """The block of ``x`` that the mesh device at ``coord`` (an index
        into ``mesh.devices``) holds, a view."""
        for d, w in enumerate(self.shard_shape(x.shape)):
            x = x.narrow(d, self._index(d, coord) * w, w)
        return x

    def assemble(self, blocks: dict, global_shape: Sequence[int]) -> torch.Tensor:
        """The tensor of ``global_shape`` from ``{coord: block}`` over every
        device of the mesh (each replica writes the same values)."""
        first = next(iter(blocks.values()))
        out = first.new_empty(tuple(global_shape))
        shard = self.shard_shape(global_shape)
        for coord, blk in blocks.items():
            view = out
            for d, w in enumerate(shard):
                view = view.narrow(d, self._index(d, coord) * w, w)
            view.copy_(blk)
        return out

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def _axis_size(mesh: Mesh, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return int(math.prod(mesh.shape[a] for a in axes))


def _entry(axes: Axes):
    return tuple(axes) if not isinstance(axes, str) else axes


def _fsdp_spec(shape, mesh: Mesh, axes: Axes) -> P:
    """Split the largest divisible dim over ``axes``; replicate otherwise."""
    size = _axis_size(mesh, axes)
    if size == 1 or not shape:
        return P()
    order = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    for i in order:
        if shape[i] % size == 0 and shape[i] >= size:
            spec = [None] * len(shape)
            spec[i] = _entry(axes)
            return P(*spec)
    return P()


def tree_shardings(t: Any, mesh: Mesh, fsdp: Axes) -> Any:
    """FSDP ``NamedSharding`` for every leaf of a tree."""
    return tree.map(lambda leaf: NamedSharding(
        mesh, _fsdp_spec(tuple(leaf.shape), mesh, fsdp)), t)


def _batch_spec(shape, mesh: Mesh, axes: Axes, dim: int = 0) -> P:
    size = _axis_size(mesh, axes)
    if size == 1 or len(shape) <= dim or shape[dim] % size != 0:
        return P()
    spec = [None] * len(shape)
    spec[dim] = _entry(axes)
    return P(*spec)


def batch_shardings(t: Any, mesh: Mesh, batch_axes: Axes) -> Any:
    """Split the leading (batch) dim of every leaf over ``batch_axes``."""
    return tree.map(lambda leaf: NamedSharding(
        mesh, _batch_spec(tuple(leaf.shape), mesh, batch_axes)), t)


def _keys(path: str) -> list:
    """A path string's keys as the reference reads them: dict keys and
    NamedTuple fields by name, sequence indices as ''."""
    return ["" if k.isdigit() else k.lstrip(".") for k in path.split("/")]


def cache_shardings(caches: Any, mesh: Mesh, batch_axes: Axes,
                    kv_seq_axes: Axes = None) -> Any:
    """Decode-cache shardings. KV caches ``k``/``v`` are (B, S, KV, Dh) and
    recurrent states ``h``/``conv`` have batch leading; leaves under the
    scanned ``groups`` subtree carry one extra leading (n_groups) axis. The
    batch dim splits over ``batch_axes``, the KV sequence dim (dim batch+1
    of k/v) over ``kv_seq_axes`` when divisible."""
    def spec_for(path: str, leaf) -> NamedSharding:
        keys = _keys(path)
        offset = 1 if "groups" in keys else 0
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        bsize = _axis_size(mesh, batch_axes)
        if bsize > 1 and len(shape) > offset and shape[offset] % bsize == 0:
            spec[offset] = _entry(batch_axes)
        is_kv = keys and keys[-1] in ("k", "v")
        ssize = _axis_size(mesh, kv_seq_axes)
        if (is_kv and ssize > 1 and len(shape) > offset + 1
                and shape[offset + 1] % ssize == 0):
            spec[offset + 1] = _entry(kv_seq_axes)
        return NamedSharding(mesh, P(*spec))

    return tree.map_with_path(spec_for, caches)
