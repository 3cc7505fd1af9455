"""Meshes and ``shard_map`` over rank processes (port of
``src/repro/dist/compat.py``).

The reference builds device meshes and maps bodies over them with
``shard_map``. On one card the port keeps the reference's calls and reads
them as the multi-process path does: a ``Mesh`` is a descriptor (axis
shape, axis names, the device, and a ``devices`` array of rank ids), and
the elements of its *manual* axes, those ``shard_map`` names in
``axis_names`` (every axis when it names none), are rank processes of a
``repro_torch.launch.spmd_qr.LaneGroup``: element i, counted row-major
over the manual axes, runs in rank i. The automatic axes run inside the
rank on its one device, replicated. That is what the reference's own
shim does on legacy jax (``shard_map``'s docstring there), with the same
results for bodies that reduce only over manual axes.

A mesh spawns its ranks at its first use (or takes the first ranks of a
group it was given, which it then does not own) and stops them at
``close()``. Inside a body, ``axis(name)`` is the ``AxisComm`` of the
element's line along that axis (a gloo subgroup of its ranks, or the
default group when the line is the whole group), and ``pmean`` reduces
over it: the lines' values are gathered in element order and summed there
(``AxisComm.psum``), so the mean's bits equal a one-process sum in that
order. A mesh made with ``threads=True`` runs its elements as threads of
this process instead, each with an in-process axis of the same arithmetic:
the one-process counterpart of a mapped body, bit for bit. ``run_manual``
runs a body on every element, once or, with a session token, as a
resident body that keeps its state in each element between calls (the
pod train step).

``PartitionSpec`` (``P``) names, per dimension, the axes it is split over
(None, a name or a tuple of names); ``in_specs`` and ``out_specs`` may be
prefixes of the argument and result trees, as in the reference. An output
replicated over an axis is the copy of that axis's element 0.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch import tree


class PartitionSpec:
    """Per dimension, the mesh axes it is split over: None, a name, or a
    tuple of names (the counterpart of ``jax.sharding.PartitionSpec``).
    Not a tuple, so trees of specs keep a spec as one leaf."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(tuple(p) if isinstance(p, list) else p
                           for p in parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self) -> int:
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.parts == other.parts
        return isinstance(other, tuple) and self.parts == other

    def __hash__(self) -> int:
        return hash(self.parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.parts!r}"


P = PartitionSpec


def spec_axes(entry) -> tuple:
    """The axis names of one dimension's entry of a spec."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """A mesh of ``axis_shapes`` named ``axis_names`` on ``device``.

    ``devices`` is the array of rank ids (default ``arange``, in the mesh's
    shape); ``shape`` maps each axis name to its size. ``group`` lends the
    mesh the first ranks of a ``LaneGroup`` (the mesh does not close it);
    otherwise the mesh spawns its own at the first use that needs ranks.
    ``threads=True`` runs the elements as threads of this process."""

    def __init__(self, axis_shapes: Sequence[int], axis_names: Sequence[str],
                 *, device="cuda", devices=None, group=None,
                 threads: bool = False, timeout_s: float = 120.0):
        self.axis_names = tuple(axis_names)
        shape = tuple(int(s) for s in axis_shapes)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"axis shape {shape} and names "
                             f"{self.axis_names} differ in length")
        self.devices = (np.arange(math.prod(shape)).reshape(shape)
                        if devices is None else np.asarray(devices))
        if self.devices.shape != shape:
            raise ValueError(f"devices of shape {self.devices.shape} for "
                             f"axes {shape}")
        self._device = device
        self.threads = threads
        self.timeout_s = timeout_s
        self._group = group
        self._owns_group = False

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device(self) -> torch.device:
        from repro_torch.kernels.backend import resolve_device

        return resolve_device(self._device)

    @property
    def group(self):
        """The ``LaneGroup`` the mesh holds (None before its first use)."""
        return self._group

    def ranks(self, n: int):
        """A ``LaneGroup`` with at least ``n`` ranks: the mesh's own (spawned
        now at ``n`` ranks if it has none) or the one it was given."""
        from repro_torch.launch.spmd_qr import LaneGroup

        if self.threads:
            raise ValueError("a mesh of threads has no ranks")
        if self._group is None:
            self._group = LaneGroup(n, self._device, self.timeout_s)
            self._owns_group = True
        if self._group.size < n:
            raise ValueError(f"{n} elements do not fit the mesh's group of "
                             f"{self._group.size} ranks")
        return self._group

    def close(self) -> None:
        """Stop the ranks the mesh spawned (a group it was lent stays)."""
        if self._owns_group and self._group is not None:
            self._group.close()
            self._group = None
            self._owns_group = False

    def __enter__(self) -> "Mesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, device={self._device!r}"
                f"{', threads' if self.threads else ''})")


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], *,
              devices=None, device="cuda", group=None, threads: bool = False,
              timeout_s: float = 120.0) -> Mesh:
    """A ``Mesh`` (the reference's ``jax.make_mesh``); it spawns nothing
    until a body runs on it."""
    return Mesh(axis_shapes, axis_names, device=device, devices=devices,
                group=group, threads=threads, timeout_s=timeout_s)


_AMBIENT: List[Mesh] = []


@contextlib.contextmanager
def set_mesh(mesh: Mesh, ranks: Optional[int] = None):
    """The ambient mesh (``current_mesh``) for the enclosed code; with
    ``ranks`` its group is spawned now rather than at the first use."""
    if ranks is not None:
        mesh.ranks(ranks)
    _AMBIENT.append(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def current_mesh() -> Optional[Mesh]:
    return _AMBIENT[-1] if _AMBIENT else None


# -- the axes of a running body ------------------------------------------------

_BOUND = threading.local()


@contextlib.contextmanager
def bind_axes(comms: Dict[str, Any]):
    """Bind the manual axes' comms for the enclosed body (this thread)."""
    prev = getattr(_BOUND, "comms", None)
    _BOUND.comms = dict(comms)
    try:
        yield
    finally:
        _BOUND.comms = prev


def axis(name: str):
    """The comm of the running body's line along manual axis ``name``: an
    ``AxisComm`` in a rank, a ``ThreadAxis`` in a thread."""
    comms = getattr(_BOUND, "comms", None)
    if not comms or name not in comms:
        raise NameError(f"axis {name!r} is not bound: reduce over it inside "
                        "a body mapped over a mesh that names it")
    return comms[name]


def pmean(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The mean of ``x`` over the manual axis ``axis_name`` (the
    reference's ``jax.lax.pmean``): the sum in element order, over the
    count."""
    comm = axis(axis_name)
    return comm.psum(x.unsqueeze(0))[0] / comm.axis_size()


class _Hub:
    """Where the threads of one line meet: each puts its value, all wait,
    each reads every value, all wait again."""

    def __init__(self, n: int, timeout_s: float):
        self.slots: List[Any] = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout_s)

    def exchange(self, i: int, x) -> list:
        self.slots[i] = x
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class ThreadAxis:
    """An element of a manual axis run as a thread: ``psum`` (on a value
    with a unit leading axis, as ``AxisComm`` takes it) joins the line's
    values in element order and sums them there."""

    def __init__(self, hub: _Hub, index: int):
        self.hub, self.rank, self.P = hub, index, len(hub.slots)

    def axis_size(self) -> int:
        return self.P

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        parts = self.hub.exchange(self.rank, x)
        return torch.sum(torch.cat(parts), dim=0, keepdim=True)


# -- running a body on every element -------------------------------------------


def manual_axes(mesh: Mesh, axis_names: Optional[Set[str]] = None) -> tuple:
    """The mesh's manual axes in mesh order (every axis when
    ``axis_names`` is None)."""
    if axis_names is not None:
        unknown = set(axis_names) - set(mesh.axis_names)
        if unknown:
            raise ValueError(f"axes {sorted(unknown)} are not in {mesh}")
    return tuple(a for a in mesh.axis_names
                 if axis_names is None or a in axis_names)


def _coords(mesh: Mesh, manual: tuple) -> List[Dict[str, int]]:
    sizes = [mesh.shape[a] for a in manual]
    return [dict(zip(manual, np.unravel_index(i, sizes)))
            for i in range(math.prod(sizes))]


def element_lines(mesh: Mesh, manual: tuple) -> List[Dict[str, tuple]]:
    """For each element, per manual axis, the elements of its line along
    that axis in the axis's order."""
    coords = _coords(mesh, manual)
    index = {tuple(int(c[a]) for a in manual): i for i, c in enumerate(coords)}
    out = []
    for c in coords:
        lines = {}
        for a in manual:
            lines[a] = tuple(index[tuple(int(k) if b == a else int(c[b])
                                         for b in manual)]
                             for k in range(mesh.shape[a]))
        out.append(lines)
    return out


# What the elements of a resident body keep between its calls, by (session
# token, element): in a rank process its own element's, in this process
# those of a mesh of threads. Each holds the element's comms (in a rank),
# its staging buffers, and what the body keeps there.
_KEPT: Dict[tuple, dict] = {}
# This process's side of the ranks' staging buffers: the one it packs each
# session's arguments into, and the ones each element answers through.
_INBOX: Dict[str, torch.Tensor] = {}
_OUTBOX: Dict[tuple, torch.Tensor] = {}


class _Staged:
    """A tensor leaf that travels in a staging buffer: its place there."""

    __slots__ = ("off", "dtype", "shape")

    def __init__(self, off: int, dtype, shape):
        self.off, self.dtype, self.shape = off, dtype, shape


def _pack(tensors: Dict[int, torch.Tensor], device: torch.device,
          old: Optional[torch.Tensor]) -> tuple:
    """``(marks, buffer, fresh)``: the tensors on ``device``'s type packed
    into a staging buffer (``old`` when it holds them), ``marks`` a
    ``_Staged`` for each by its key; None for the buffer when there are
    none."""
    from repro_torch.launch import spmd_qr as sq

    tensors = {k: v for k, v in tensors.items()
               if v.device.type == device.type}
    if not tensors:
        return {}, old, False
    plan, nbytes = sq.staging_layout(tensors)
    buf, fresh = sq.staging_buffer(nbytes, device, old)
    for k, off, dt, shape in plan:
        sq.staging_slot(buf, off, dt, shape).copy_(tensors[k])
    sq.sync_device(device)
    return {k: _Staged(off, dt, shape) for k, off, dt, shape in plan}, buf, fresh


def _unpack(node, buf: Optional[torch.Tensor]):
    """``node`` with each ``_Staged`` leaf read out of ``buf`` and every
    tensor leaf copied: copies this process owns, each on its leaf's
    device."""
    from repro_torch.launch.spmd_qr import staging_slot

    return tree.map(lambda x: staging_slot(buf, x.off, x.dtype, x.shape).clone()
                    if isinstance(x, _Staged) else owned(x), node)


def run_manual(f: Callable, mesh: Mesh, each: Sequence[tuple],
               axis_names: Optional[Set[str]] = None,
               session: Optional[str] = None) -> List[Any]:
    """``f(*each[i])`` on element i of the mesh's manual axes, with those
    axes bound (``axis``); the elements' results in element order. On
    ranks ``f`` must be a module-level function (or a ``functools.partial``
    of one), the results are copies this process owns, and the ranks'
    reports go to ``group.last_reports``.

    With ``session`` (a token) the body is resident: element i keeps a
    dict between the calls of that session and ``f`` gets it first,
    ``f(kept, *each[i])``. On ranks a session's tensors travel through
    staging buffers shared once, this process's for the arguments (a
    tensor that several elements take is packed once) and each rank's for
    its result, so a large tree costs a copy, not a mapping a leaf.
    ``drop_session`` frees what the elements keep. A call that raises drops
    the session's buffers, and each element that raised what it kept."""
    manual = manual_axes(mesh, axis_names)
    lines = element_lines(mesh, manual)
    if len(each) != len(lines):
        raise ValueError(f"{len(each)} argument tuples for {len(lines)} "
                         "elements")
    if mesh.threads:
        return _run_threads(f, mesh, each, lines, session)
    from repro_torch.launch.spmd_qr import RankReport

    group = mesh.ranks(len(lines))
    group.groups([line for ls in lines for line in ls.values()])
    device = mesh.device
    inbox = None
    if session is not None:
        tensors = {id(x): x for args in each for x in tree.leaves(args)
                   if isinstance(x, torch.Tensor)}
        marks, _INBOX[session], fresh = _pack(tensors, device,
                                              _INBOX.get(session))
        each = [tree.map(lambda x: marks.get(id(x), x), tuple(args))
                for args in each]
        inbox = _INBOX[session] if fresh else None
    try:
        outs = group.run(
            _element_rank, f, str(device), session, inbox,
            each=[(tuple(args), ls, i, (session, i) not in _OUTBOX)
                  for i, (args, ls) in enumerate(zip(each, lines))],
            ranks=len(lines))
    except BaseException:
        _drop_buffers(session)
        raise
    group.last_reports = [RankReport(i, *rep) for i, (_, rep) in enumerate(outs)]
    results = []
    for i, ((out, box), _) in enumerate(outs):
        if box is not None:
            _OUTBOX[(session, i)] = box
        results.append(_unpack(out, _OUTBOX.get((session, i))))
    if session is not None:
        # the copies read the ranks' buffers before their next call
        # rewrites them
        from repro_torch.launch.spmd_qr import sync_device

        sync_device(device)
    return results


def _drop_buffers(session: Optional[str]) -> None:
    _INBOX.pop(session, None)
    for key in [k for k in _OUTBOX if k[0] == session]:
        del _OUTBOX[key]


def drop_session(mesh: Mesh, session: str,
                 axis_names: Optional[Set[str]] = None) -> None:
    """Free what the elements of ``session`` keep, and its buffers (the
    mesh's ranks stay)."""
    _drop_buffers(session)
    n = len(_coords(mesh, manual_axes(mesh, axis_names)))
    if mesh.threads:
        for i in range(n):
            _KEPT.pop((session, i), None)
    elif mesh.group is not None and not mesh.group.closed:
        mesh.group.run(_drop_kept, session, each=[(i,) for i in range(n)],
                       ranks=n)


def _drop_kept(index: int, session: str) -> None:
    if _KEPT.pop((session, index), None) is not None:
        torch.cuda.empty_cache()


def owned(x):
    """A copy of a tensor leaf this process owns (other leaves as they
    are)."""
    return x.clone() if isinstance(x, torch.Tensor) else x


def _run_threads(f: Callable, mesh: Mesh, each, lines,
                 session: Optional[str]) -> List[Any]:
    hubs = {}
    for ls in lines:
        for a, line in ls.items():
            hubs.setdefault((a, line), _Hub(len(line), mesh.timeout_s))
    results: List[Any] = [None] * len(each)
    errors: List[Optional[BaseException]] = [None] * len(each)
    # a new thread starts with the library's default intra-op thread count,
    # which can change a CPU product's bits: each takes the caller's
    n_threads = torch.get_num_threads()

    def body(i: int) -> None:
        torch.set_num_threads(n_threads)
        comms = {a: ThreadAxis(hubs[(a, line)], line.index(i))
                 for a, line in lines[i].items()}
        try:
            with bind_axes(comms):
                if session is None:
                    results[i] = f(*each[i])
                else:
                    kept = _KEPT.pop((session, i), {})
                    results[i] = f(kept, *each[i])
                    _KEPT[(session, i)] = kept
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            errors[i] = e
            for hub in hubs.values():
                hub.barrier.abort()

    threads = [threading.Thread(target=body, args=(i,), daemon=True)
               for i in range(len(each))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    raised = [e for e in errors if e is not None]
    if raised:
        first = [e for e in raised
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or raised)[0]
    return results


def _element_rank(args: tuple, lines: Dict[str, tuple], index: int,
                  need_box: bool, f: Callable, device: str,
                  session: Optional[str], inbox: Optional[torch.Tensor]):
    """A rank's element: its own copies of the arguments (each on its
    leaf's device), the manual axes bound to ``AxisComm``s over its lines,
    ``f`` run and measured (seconds, launches, staging, peak memory). In a
    session the comms and buffers are kept, and the result's tensors are
    packed into the rank's own buffer (sent with the answer when it is new
    or this process asks for it)."""
    from repro_torch.core.comm import AxisComm, StagingStats
    from repro_torch.launch.spmd_qr import measured_call, rank_group

    dev = torch.device(device)
    kept = _KEPT.pop((session, index), None) if session is not None else None
    if kept is None:
        kept = {"comms": {a: AxisComm(rank_group(line))
                          for a, line in lines.items()}}
    if inbox is not None:
        kept["inbox"] = inbox
    comms = kept["comms"]
    for c in comms.values():
        c.stats = StagingStats()
    own = _unpack(args, kept.get("inbox"))

    def body():
        with bind_axes(comms):
            return f(*own) if session is None else f(kept, *own)

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    out, seconds, launches = measured_call(dev, body)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    staged: Dict[str, float] = {}
    for c in comms.values():
        for k, v in vars(c.stats).items():
            staged[k] = staged.get(k, 0) + v
    box = None
    if session is not None:
        tensors = {str(i): x for i, x in enumerate(tree.leaves(out))
                   if isinstance(x, torch.Tensor)}
        marks, kept["outbox"], fresh = _pack(tensors, dev, kept.get("outbox"))
        by_id = {id(tensors[k]): m for k, m in marks.items()}
        out = tree.map(lambda x: by_id.get(id(x), x), out)
        box = kept["outbox"] if fresh or need_box else None
        _KEPT[(session, index)] = kept
    return (out, box), (seconds, launches, staged, peak)


# -- shard_map -----------------------------------------------------------------


def _map_spec(fn: Callable, spec, node):
    """``fn(leaf, spec)`` over ``node`` for a spec tree that is a prefix of
    it (a spec, or None for ``P()``, stands for every leaf below)."""
    if spec is None or isinstance(spec, PartitionSpec):
        s = P() if spec is None else spec
        return tree.map(lambda x: fn(x, s), node)
    if isinstance(node, dict):
        return {k: _map_spec(fn, spec[k], node[k]) for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_spec(fn, s, c) for s, c in zip(spec, node)))
    return type(node)(_map_spec(fn, s, c) for s, c in zip(spec, node))


def _offset(spec: PartitionSpec, d: int, sizes: Dict[str, int],
            coord: Dict[str, int]) -> tuple:
    """(block index, block count) of dimension ``d`` at ``coord``."""
    axes = spec_axes(spec[d])
    k = math.prod(sizes[a] for a in axes)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + int(coord[a])
    return idx, k


def _block(x, spec: PartitionSpec, sizes, coord):
    if not isinstance(x, torch.Tensor):
        return x
    for d in range(len(spec)):
        idx, k = _offset(spec, d, sizes, coord)
        if k > 1:
            if x.shape[d] % k:
                raise ValueError(f"dimension {d} of {tuple(x.shape)} does not "
                                 f"split over {spec[d]!r} ({k})")
            w = x.shape[d] // k
            x = x.narrow(d, idx * w, w)
    return x


def _assemble(parts: list, spec: PartitionSpec, sizes, coords, manual):
    """One output leaf from the elements' blocks: along each split
    dimension the blocks joined; over the axes the spec leaves out, the
    copy of element 0 of the axis."""
    used = {a for entry in spec for a in spec_axes(entry)}
    reps = [i for i, c in enumerate(coords)
            if all(int(c[a]) == 0 for a in manual if a not in used)]
    x0 = parts[reps[0]]
    if not isinstance(x0, torch.Tensor):
        return x0
    shape = list(x0.shape)
    for d in range(len(spec)):
        shape[d] *= _offset(spec, d, sizes, coords[0])[1]
    out = x0.new_empty(shape)
    for i in reps:
        view = out
        for d in range(len(spec)):
            idx, k = _offset(spec, d, sizes, coords[i])
            if k > 1:
                view = view.narrow(d, idx * x0.shape[d], x0.shape[d])
        view.copy_(parts[i])
    return out


def shard_map(f: Callable, mesh: Mesh, in_specs, out_specs, *,
              check: bool = False, axis_names: Optional[Set[str]] = None):
    """``f`` mapped over the mesh's manual axes (``axis_names``; default
    every axis): each argument split by its spec among the elements, ``f``
    run on each (in a rank, or a thread of a ``threads`` mesh), the results
    joined by ``out_specs``. ``check`` (the reference's replication check)
    is accepted and not run, as the reference's default."""
    manual = manual_axes(mesh, axis_names)
    sizes = {a: mesh.shape[a] for a in manual}
    coords = _coords(mesh, manual)

    def mapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"{len(args)} arguments for {len(in_specs)} "
                             "in_specs")
        each = [tuple(_map_spec(lambda x, s: _block(x, s, sizes, c), spec, a)
                      for spec, a in zip(in_specs, args)) for c in coords]
        outs = run_manual(f, mesh, each, set(manual))
        flat = [dict(tree.flatten_with_path(o)) for o in outs]
        spec_of = dict(tree.flatten_with_path(
            _map_spec(lambda x, s: s, out_specs, outs[0])))
        return tree.map_with_path(
            lambda path, _: _assemble([fl[path] for fl in flat],
                                      spec_of[path], sizes, coords, manual),
            outs[0])

    return mapped
