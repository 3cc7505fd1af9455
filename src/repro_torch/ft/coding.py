"""Coded checksum lanes: survive any ``f`` simultaneous lane deaths (port of
``src/repro/ft/coding.py``).

The paper's XOR buddy pairing recovers one death per pair from ONE
survivor; a whole pair dying at the same sweep point is
``UnrecoverableFailure``. ``MDSScheme`` adds ``f`` parity slots that
encode every protected ``SweepState`` leaf over a Vandermonde generator in
GF(2^8), so ANY ``t <= f`` simultaneously dead lanes are jointly decodable
from the ``P - t`` survivors plus the parity slots.

Bitwise exactness: the code works on the RAW BYTES of each protected leaf
(the IEEE values as stored, the bytes JAX's ``bitcast_convert_type``
gives), parity row ``j`` is ``P_j = XOR_i g[j, i] (x) B_i`` with GF(2^8)
constant multiplies, and decode solves the ``t x t`` Vandermonde system
exactly on the host. GF arithmetic on bit patterns is exact, so the decoded
floats are bit-identical to the dead lanes' state at the last encode, and
the parity bytes equal the JAX package's on the same input bytes.

Generator: ``g[j, i] = (alpha^i)^j`` (poly 0x11D, ``P <= 255``); row 0 is
all-ones, the plain XOR checksum. Hybrid rule (``recover_lanes``): one
newly dead lane always takes the paper's single-source XOR REBUILD, so
``MDSScheme(f=1)`` is bit-identical to ``XORPairScheme``, ledgers
included; only ``2 <= t <= f`` simultaneous deaths take the joint decode.

A constant multiply runs one lane at a time, through a 256-entry row of
the product table indexed with an int32 copy of a chunk of the lane's
bytes (a ``uint8`` index would read as a mask, and an int64 index over the
whole state would take 8 bytes per byte), XORed into the parity slot. It
is plain PyTorch on either device; in the JAX package it is a ``jnp``
gather, not a Pallas kernel. Under ``AxisComm`` (one lane a process) each
rank multiplies its own bytes and one ``xor_reduce`` a refresh (or a
decode) combines every protected leaf's terms across the ranks
(``_encode_axis``, ``_decode_axis``); XOR is exact in any order, so the
parity bytes equal ``SimComm``'s.

The XOR pairing helpers (``xor_buddy``, ``pairing_table``) live in
``repro_torch.core.recovery`` and are re-exported here, as the reference
exports them.
"""
from __future__ import annotations

import dataclasses
from typing import AbstractSet, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.comm import SimComm
from repro_torch.core.recovery import pairing_table, xor_buddy  # noqa: F401
from repro_torch.ft.failures import UnrecoverableFailure

# -- GF(2^8) arithmetic (poly 0x11D) -----------------------------------------

_POLY = 0x11D


def _gf_tables():
    exp = np.zeros(510, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]
    return exp, log


GF_EXP, GF_LOG = _gf_tables()

# the full 256x256 product table; row c is the constant multiply by c
_MUL = GF_EXP[np.add.outer(GF_LOG, GF_LOG)].astype(np.uint8)
_MUL[0, :] = 0
_MUL[:, 0] = 0


def gf_mul(a: int, b: int) -> int:
    return int(_MUL[a, b])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no GF(2^8) inverse")
    return int(GF_EXP[255 - GF_LOG[a]])


def generator(f: int, P: int) -> np.ndarray:
    """The (f, P) Vandermonde MDS generator ``g[j, i] = (alpha^i)^j``. Row
    0 is all-ones; rows depend only on ``j``, so a decode with ``t <= f``
    rows uses the same coefficients whatever ``f``."""
    if P > 255:
        raise ValueError(f"GF(2^8) coding supports at most 255 lanes, got {P}")
    j = np.arange(f)[:, None]
    i = np.arange(P)[None, :]
    return GF_EXP[(j * i) % 255].astype(np.uint8)


def gf_inv_matrix(M: np.ndarray) -> np.ndarray:
    """Exact GF(2^8) matrix inverse by Gaussian elimination (host side; the
    decode systems are tiny ``t x t`` Vandermonde submatrices)."""
    M = np.asarray(M)
    t = M.shape[0]
    aug = np.concatenate([M.astype(np.int32),
                          np.eye(t, dtype=np.int32)], axis=1)
    for c in range(t):
        piv = c + int(np.nonzero(aug[c:, c])[0][0])
        aug[[c, piv]] = aug[[piv, c]]
        aug[c] = _MUL[gf_inv(int(aug[c, c])), aug[c]]
        for r in range(t):
            if r != c and aug[r, c]:
                aug[r] ^= _MUL[aug[r, c], aug[c]].astype(np.int32)
    return aug[:, t:].astype(np.uint8)


# -- byte-level constant multiplies --------------------------------------------

_CHUNK = 1 << 24  # bytes a gather converts to int32 at a time
_MUL_ROWS: Dict[Tuple[int, str], torch.Tensor] = {}


def _mul_row(coef: int, device: torch.device) -> torch.Tensor:
    key = (coef, str(device))
    row = _MUL_ROWS.get(key)
    if row is None:
        row = torch.from_numpy(_MUL[coef].copy()).to(device)
        _MUL_ROWS[key] = row
    return row


def _gf_axpy(acc: torch.Tensor, coef: int, x: torch.Tensor) -> None:
    """``acc ^= coef (x) x`` in place, over flat uint8 tensors."""
    if coef == 0:
        return
    if coef == 1:
        acc.bitwise_xor_(x)
        return
    row = _mul_row(coef, x.device)
    for s in range(0, x.numel(), _CHUNK):
        idx = x[s:s + _CHUNK].to(torch.int32)
        acc[s:s + _CHUNK].bitwise_xor_(torch.index_select(row, 0, idx))


def _lane_bytes(x: torch.Tensor, ax: int, lane: int) -> torch.Tensor:
    """The bytes of one lane's slice of ``x``, flat, in the order of the
    slice's elements (each element's bytes in memory order)."""
    return x.select(ax, lane).contiguous().reshape(-1).view(torch.uint8)


def _byte_shape(x: torch.Tensor, ax: int) -> Tuple[int, ...]:
    """The shape JAX's ``bitcast_convert_type`` to uint8 gives one lane's
    slice: the slice's shape plus a trailing axis of the element size."""
    shape = list(x.shape)
    del shape[ax]
    return (*shape, x.element_size())


# -- protected-leaf selection -------------------------------------------------


def _protected_leaves(state) -> List[Tuple[str, int]]:
    """``(flat_arrays key, lane_axis)`` of every parity-protected leaf, in
    flattening order: float leaves with a lane axis, exactly what
    ``obliterate_state`` poisons. ``A0`` and the parity field itself are
    excluded."""
    from repro_torch.ft.online.state import flat_arrays, state_lane_axes

    leaves = flat_arrays(state)
    axes = flat_arrays(state_lane_axes(state).replace(A0=-1))
    return [(key, axes[key]) for key, x in leaves.items()
            if axes[key] >= 0 and x.is_floating_point()]


def _protected(state) -> List[Tuple[int, int]]:
    """``(flat_leaf_index, lane_axis)`` of every protected leaf, as the
    reference's ``_protected`` gives them: the index is the leaf's position
    in ``flat_arrays`` order, which is the order of JAX's ``tree_leaves``
    over a ``SweepState``."""
    from repro_torch.ft.online.state import flat_arrays

    index = {key: i for i, key in enumerate(flat_arrays(state))}
    return [(index[key], ax) for key, ax in _protected_leaves(state)]


# -- encode / decode bodies ---------------------------------------------------


def _encode_sim(state, G: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """Parity tuple over the protected leaves, SimComm layout: one
    ``(f, *byte_shape)`` uint8 tensor per protected leaf, on its device."""
    from repro_torch.ft.online.state import flat_arrays

    f, P = G.shape
    leaves = flat_arrays(state)
    out = []
    for key, ax in _protected_leaves(state):
        x = leaves[key]
        shape = _byte_shape(x, ax)
        parity = torch.zeros((f, int(np.prod(shape))), dtype=torch.uint8,
                             device=x.device)
        for i in range(P):
            bl = _lane_bytes(x, ax, i)
            for j in range(f):
                _gf_axpy(parity[j], int(G[j, i]), bl)
        out.append(parity.reshape(f, *shape))
    return tuple(out)


def _lane_terms(state, coefs: Sequence[int], zero: bool):
    """This rank's GF(2^8) terms ``coef (x) bytes`` of every protected leaf
    (AxisComm layout: a unit lane axis), flat and concatenated, with each
    leaf's ``(key, byte count, byte shape)``; all zeros when
    ``zero`` (a dead rank contributes nothing)."""
    from repro_torch.ft.online.state import flat_arrays

    leaves = flat_arrays(state)
    terms, layout = [], []
    for key, ax in _protected_leaves(state):
        x = leaves[key]
        bl = _lane_bytes(x, ax, 0)
        t = torch.zeros((len(coefs), bl.numel()), dtype=torch.uint8,
                        device=x.device)
        if not zero:
            for j, c in enumerate(coefs):
                _gf_axpy(t[j], int(c), bl)
        terms.append(t.reshape(-1))
        layout.append((key, bl.numel(), _byte_shape(x, ax)))
    return torch.cat(terms), layout


def _encode_axis(comm, state, G: np.ndarray) -> Tuple[torch.Tensor, ...]:
    """``_encode_sim``'s parity tuple under ``AxisComm``: each rank's terms
    of every protected leaf, XOR-reduced over the ranks in one collective;
    every rank holds the (replicated) parity."""
    f = G.shape[0]
    lane = int(comm.axis_index()[0])
    flat, layout = _lane_terms(state, G[:, lane], zero=False)
    red = comm.xor_reduce(flat[None])
    out, off = [], 0
    for _key, n, shape in layout:
        out.append(red[off:off + f * n].reshape(f, *shape))
        off += f * n
    return tuple(out)


def _decode_sim(state, live: Sequence[bool], dead_idx: Sequence[int],
                inv: np.ndarray):
    """Joint reconstruction of the ``t = len(dead_idx)`` dead lanes' slices
    of every protected leaf from the survivors (``live``) and parity rows
    ``0..t-1`` of ``state.code``. Returns a new state; ``state`` keeps its
    tensors."""
    from repro_torch.ft.online.state import flat_arrays, replace_arrays

    P = len(live)
    t = len(dead_idx)
    Gt = generator(t, P)
    leaves = flat_arrays(state)
    prot = _protected_leaves(state)
    code = state.code
    assert code is not None and len(code) == len(prot), (
        "parity slots out of step with the protected leaves")
    new: Dict[str, torch.Tensor] = {}
    for parity, (key, ax) in zip(code, prot):
        x = leaves[key]
        par = parity.reshape(parity.shape[0], -1)
        synd = [par[j].clone() for j in range(t)]
        for i in range(P):
            if live[i]:
                bl = _lane_bytes(x, ax, i)
                for j in range(t):
                    _gf_axpy(synd[j], int(Gt[j, i]), bl)
        out = x.clone()
        for r, d in enumerate(dead_idx):
            acc = torch.zeros_like(synd[0])
            for j in range(t):
                _gf_axpy(acc, int(inv[r, j]), synd[j])
            dst = out.select(ax, d)
            dst.copy_(acc.view(x.dtype).reshape(dst.shape))
        new[key] = out
    return replace_arrays(state, new)


def _decode_axis(comm, state, newly: Sequence[int], dead: AbstractSet[int],
                 inv: np.ndarray):
    """``_decode_sim`` under ``AxisComm``: the survivors' terms are
    XOR-reduced in one collective, and each newly dead rank solves for its
    own bytes of every protected leaf; every other rank keeps its state."""
    from repro_torch.ft.online.state import flat_arrays, replace_arrays

    P = comm.axis_size()
    t = len(newly)
    lane = int(comm.axis_index()[0])
    Gt = generator(t, P)
    flat, layout = _lane_terms(state, Gt[:, lane], zero=lane in dead)
    red = comm.xor_reduce(flat[None])
    if lane not in newly:
        return state
    r = sorted(newly).index(lane)
    code = state.code
    assert code is not None and len(code) == len(layout), (
        "parity slots out of step with the protected leaves")
    leaves = flat_arrays(state)
    new: Dict[str, torch.Tensor] = {}
    off = 0
    for parity, (key, n, _shape) in zip(code, layout):
        par = parity.reshape(parity.shape[0], -1)
        acc = torch.zeros(n, dtype=torch.uint8, device=par.device)
        for j in range(t):
            synd = par[j].clone()
            synd.bitwise_xor_(red[off + j * n:off + (j + 1) * n])
            _gf_axpy(acc, int(inv[r, j]), synd)
        off += t * n
        x = leaves[key]
        new[key] = acc.view(x.dtype).reshape(x.shape)
    return replace_arrays(state, new)


# -- the schemes --------------------------------------------------------------


class CodingScheme:
    """The redundancy seam of the FT stack.

    ``f``        guaranteed number of simultaneous deaths recoverable;
    ``joint``    whether ``decode_lanes`` exists (multi-death GF decode);
    ``refresh``  re-encode the parity slots at an interruptible boundary
                 (identity for pure XOR pairing);
    ``decode_lanes``  jointly reconstruct all newly-dead lanes, returning
                 ``(state, reads)`` with the multi-source decode ledger.

    ``recover_lanes`` (``repro_torch.ft.driver``) consults the scheme: one
    newly dead lane always takes the paper's single-source XOR REBUILD;
    ``2 <= t <= f`` takes ``decode_lanes``; more falls back to the per-lane
    XOR loop, whose exhaustion raises ``UnrecoverableFailure``."""

    name = "base"
    f = 0
    joint = False

    def refresh(self, comm, state):
        return state

    def decode_lanes(self, comm, state, newly, dead):
        raise UnrecoverableFailure(
            f"scheme {self.name!r} cannot jointly decode {sorted(newly)}")


class XORPairScheme(CodingScheme):
    """The paper's scheme: pairwise XOR-buddy redundancy, single-source
    REBUILD, f=1 per pair. The bitwise oracle every other scheme is held
    against."""

    name = "xor"
    f = 1
    joint = False


@dataclasses.dataclass(frozen=True)
class MDSScheme(CodingScheme):
    """Vandermonde GF(2^8) MDS checksum slots tolerating any ``f``
    simultaneous deaths (the module docstring has the construction and
    the exactness argument)."""

    f: int = 2
    name = "mds"
    joint = True

    def __post_init__(self):
        if not 1 <= self.f <= 8:
            raise ValueError(f"MDS redundancy f={self.f} out of range [1, 8]")

    def refresh(self, comm, state):
        G = generator(self.f, comm.axis_size())
        if not isinstance(comm, SimComm):
            return state.replace(code=_encode_axis(comm, state, G))
        return state.replace(code=_encode_sim(state.replace(code=None), G))

    def decode_lanes(self, comm, state, newly, dead
                     ) -> Tuple[object, Dict[str, int]]:
        newly = sorted(newly)
        t = len(newly)
        P = comm.axis_size()
        if t > self.f:
            raise UnrecoverableFailure(
                f"{t} simultaneous deaths exceed MDS tolerance f={self.f}")
        if state.code is None:
            raise UnrecoverableFailure(
                "no parity slots encoded yet (death before the first "
                "boundary refresh)")
        inv = gf_inv_matrix(generator(t, P)[:, newly])
        live = np.ones(P, bool)
        live[sorted(dead)] = False
        if isinstance(comm, SimComm):
            state = _decode_sim(state, live.tolist(), newly, inv)
        else:
            state = _decode_axis(comm, state, newly, dead, inv)
        reads: Dict[str, int] = {
            f"coded.parity{j}": P + j for j in range(t)}
        for i in range(P):
            if live[i]:
                reads[f"coded.survivor{i}"] = i
        return state, reads
