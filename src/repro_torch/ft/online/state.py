"""The reified sweep state machine: ``SweepState`` + ``sweep_step`` (port of
``src/repro/ft/online/state.py``).

``SweepState``
    Everything the sweep holds between two interruptible points: the
    working matrix and the re-readable source, the in-flight panel
    artifacts (leaf WY factors, the TSQR butterfly ladder, C' and the
    per-level trailing bundles), the per-panel stored outputs, and the
    **cursor**, the next ``sweep_point(panel, phase, level)`` to execute.
    A frozen dataclass; the JAX package registers it as a pytree, and the
    port maps over its array fields with ``map_state`` instead.

``sweep_step(comm, state) -> state``
    Executes exactly one sweep point and advances the cursor. It calls the
    same single-level primitives the windowed sweep of ``core/caqr.py`` is
    built from (``ft_tsqr_level``, ``trailing_combine_level``,
    ``_leaf_apply``, the geometry and deposit helpers), in the same order,
    so iterating it to completion is bit-identical to ``caqr_factorize(...,
    use_scan=False)``; on the card it launches K1-K4 as the sweep does.

``run_panel_fused(comm, state) -> state``
    All of panel ``k``'s points in one launch of K6 (a CPU tensor runs its
    plain version), bit-identical to ``panel_points`` sweep_steps.

Cursor semantics (DESIGN.md §9): the boundary state after executing point
``p`` is the state the monolithic driver had after ``p``. Panel ``k``'s
writeback and deposit run at the start of the ``(k+1, leaf)`` segment, and
the last panel's deposit plus the R assembly run in ``finalize``.

No transition changes a tensor of the state it is given: the deposit's
writeback goes into the fresh concatenation that ``advance_columns``
makes, and the death-mask primitives copy.

Serialization: ``sweep_state_to_host`` / ``sweep_state_from_host`` flatten
a state to named numpy arrays plus a JSON meta record, in the JAX
package's wire format (version 2 by default, version 1 readable), so a
state either package writes at any boundary resumes in the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.caqr import (
    PanelFactors,
    SweepGeometry,
    advance_columns,
    assemble_R,
    extract_r_rows,
    make_panel_factors,
    pad_bundle,
    pad_to_geometry,
    panel_geometry,
    sweep_geometry,
)
from repro_torch.core.comm import SimComm
from repro_torch.core.householder import householder_qr_masked
from repro_torch.core.trailing import (
    RecoveryBundle,
    _leaf_apply,
    _writeback,
    trailing_combine_level,
)
from repro_torch.core.tsqr import DistTSQRFactors, _levels, ft_tsqr_level
from repro_torch.ft.failures import (
    PHASE_LEAF,
    PHASE_TSQR,
    PHASE_TRAILING,
    next_sweep_point,
    sweep_point,
)
from repro_torch.kernels.backend import resolve_device

Cursor = Optional[Tuple[int, str, int]]

# Array fields of SweepState, in the JAX package's flattening order.
_ARRAY_FIELDS = (
    "A0", "A",
    "window", "leaf_Y", "leaf_T", "R_leaf", "R_carry",
    "Y2s", "Ts", "level_Y2", "level_T",
    "C_local", "C_prime", "Ws", "Cs_self", "Cs_buddy", "tops",
    "factors", "R_rows", "bundles",
    "code",
)

# The wire format version written by default: v2 keeps the coded parity
# slots (``code``), v1 left them out.
WIRE_VERSION = 2
_V1_EXCLUDED_FIELDS = ("code",)


@dataclasses.dataclass(frozen=True, eq=False)
class SweepState:
    """Explicit loop state of the windowed FT-CAQR sweep.

    ``geom`` (the padded ``SweepGeometry``) and ``cursor`` (the next sweep
    point; ``None`` when only ``finalize`` remains) are static. Everything
    else is per-lane tensor state in the SimComm layout: the lane axis is
    position 0 for block and leaf tensors and position 1 for level-stacked
    ones (``state_lane_axes``). In-flight fields are ``None`` (empty tuples
    for the growing ladders) outside the phase that defines them.
    """

    geom: SweepGeometry
    cursor: Cursor
    # the re-readable data source (padded; never poisoned) + working matrix
    A0: Any
    A: Any
    # in-flight panel state (what a mid-panel death obliterates)
    window: Any = None
    leaf_Y: Any = None
    leaf_T: Any = None
    R_leaf: Any = None
    R_carry: Any = None
    Y2s: Tuple = ()          # TSQR butterfly ladder, one entry per level
    Ts: Tuple = ()
    level_Y2: Any = None     # stacked ladder (L, P, b, b), trailing phase
    level_T: Any = None
    C_local: Any = None      # leaf-applied live window
    C_prime: Any = None      # running C' between trailing levels
    Ws: Tuple = ()           # per-level trailing bundle slices
    Cs_self: Tuple = ()
    Cs_buddy: Tuple = ()
    tops: Tuple = ()
    # stored outputs, one entry per completed (deposited) panel
    factors: Tuple = ()      # PanelFactors
    R_rows: Tuple = ()
    bundles: Tuple = ()      # RecoveryBundle
    # coded checksum slots (``repro_torch.ft.coding``): one
    # (f, *byte_shape) uint8 parity per protected leaf, on the state's
    # device, re-encoded at every boundary by ``MDSScheme.refresh``; None
    # under the XOR scheme. No lane axis (skip-axis -1 in
    # ``state_lane_axes``, never poisoned); wire format v2 carries it.
    code: Any = None

    @property
    def levels(self) -> int:
        return self.geom.levels

    @property
    def done(self) -> bool:
        return self.cursor is None

    def replace(self, **kw) -> "SweepState":
        return dataclasses.replace(self, **kw)


def _map(fn: Callable, x, *ys):
    """``fn`` over the leaves of ``x`` (None, a tensor, a tuple or a
    NamedTuple of them), with the matching leaves of ``ys``."""
    if x is None:
        return None
    if isinstance(x, tuple):
        out = [_map(fn, *zs) for zs in zip(x, *ys)]
        return type(x)(*out) if hasattr(x, "_fields") else tuple(out)
    return fn(x, *ys)


def map_state(fn: Callable, state: SweepState, *others: SweepState
              ) -> SweepState:
    """A state of ``fn(leaf, *matching leaves of others)`` over every array
    field (the port's counterpart of ``jax.tree_util.tree_map``)."""
    return state.replace(**{
        f: _map(fn, getattr(state, f), *(getattr(o, f) for o in others))
        for f in _ARRAY_FIELDS})


def initial_sweep_state(comm, A0: torch.Tensor, panel_width: int) -> SweepState:
    """Entry state: padded source matrix, cursor at the first sweep point.
    Accepts anything ``caqr_factorize`` accepts (tall, ragged, wide)."""
    P = comm.axis_size()
    assert _levels(P) >= 1, "need at least 2 lanes to tolerate failures"
    m_loc, n = comm.local_shape(A0)
    geom = sweep_geometry(P, m_loc, n, panel_width)
    A_pad = pad_to_geometry(comm, A0, geom)
    return SweepState(geom=geom, cursor=sweep_point(0, PHASE_LEAF),
                      A0=A_pad, A=A_pad)


# -- the transition ----------------------------------------------------------


def _begin_panel_leaf(comm, s: SweepState, k: int) -> SweepState:
    """Window view + masked panel QR of panel ``k`` (K1)."""
    geom = s.geom
    col0, _t_lane, row_start, active = panel_geometry(
        comm, k, geom.b, geom.m_loc_pad)
    window = s.A[..., col0:]
    wy = householder_qr_masked(window[..., :geom.b], row_start)
    return s.replace(
        window=window,
        leaf_Y=comm.where(active, wy.Y, torch.zeros_like(wy.Y)),
        leaf_T=comm.where(active, wy.T, torch.zeros_like(wy.T)),
        R_leaf=comm.where(active, wy.R, torch.zeros_like(wy.R)),
    )


def _deposit_panel(comm, s: SweepState, k: int) -> SweepState:
    """Writeback + per-panel output deposit of the finished panel ``k``,
    then clear the in-flight fields. The writeback goes into the fresh
    concatenation of the dead columns and ``C_local``, so ``s`` itself is
    not changed."""
    geom = s.geom
    col0, t_lane, row_start, active = panel_geometry(
        comm, k, geom.b, geom.m_loc_pad)
    A = advance_columns(comm, s.A, s.C_local, col0)
    _writeback(comm, A[..., col0:], s.C_prime, row_start, active)
    r_rows = extract_r_rows(comm, s.C_prime, t_lane, col0)
    bundle = pad_bundle(RecoveryBundle(
        W=torch.stack(s.Ws),
        C_self=torch.stack(s.Cs_self),
        C_buddy=torch.stack(s.Cs_buddy),
        Y2=s.level_Y2,
        T=s.level_T,
        self_was_top=torch.stack(s.tops).to(s.C_prime.device),
    ), col0)
    pf = make_panel_factors(comm, s.leaf_Y, s.leaf_T, s.level_Y2, s.level_T,
                            row_start, active, t_lane)
    return s.replace(
        A=A,
        R_rows=s.R_rows + (r_rows,),
        bundles=s.bundles + (bundle,),
        factors=s.factors + (pf,),
        window=None, leaf_Y=None, leaf_T=None, R_leaf=None, R_carry=None,
        Y2s=(), Ts=(), level_Y2=None, level_T=None,
        C_local=None, C_prime=None, Ws=(), Cs_self=(), Cs_buddy=(), tops=(),
    )


def sweep_step(comm, state: SweepState) -> SweepState:
    """Execute exactly one sweep point (the segment ending at
    ``state.cursor``) and advance the cursor."""
    point = state.cursor
    assert point is not None, "sweep already complete; call finalize"
    geom = state.geom
    k, phase, lvl = point
    L = state.levels
    t_lane = (k * geom.b) // geom.m_loc_pad

    if phase == PHASE_LEAF:
        if k > 0:
            state = _deposit_panel(comm, state, k - 1)
        state = _begin_panel_leaf(comm, state, k)
    elif phase == PHASE_TSQR:
        carry = state.R_leaf if lvl == 0 else state.R_carry
        R_next, Y2, T = ft_tsqr_level(comm, carry, lvl, t_lane, t_lane)
        state = state.replace(
            R_carry=R_next, Y2s=state.Y2s + (Y2,), Ts=state.Ts + (T,))
    else:  # PHASE_TRAILING
        if lvl == 0:
            # stack the ladder + leaf-apply the live window (K2)
            _c0, _t, row_start, active = panel_geometry(
                comm, k, geom.b, geom.m_loc_pad)
            level_Y2 = torch.stack(state.Y2s)
            level_T = torch.stack(state.Ts)
            dist = DistTSQRFactors(state.leaf_Y, state.leaf_T, level_Y2,
                                   level_T, state.R_leaf)
            C_local, C_prime = _leaf_apply(
                comm, dist, state.window, row_start,
                active=active, skip_consumed=True)
            state = state.replace(
                level_Y2=level_Y2, level_T=level_T, C_local=C_local,
                C_prime=comm.where(active, C_prime, torch.zeros_like(C_prime)),
            )
        out = trailing_combine_level(
            comm, state.C_prime, state.level_Y2[lvl], state.level_T[lvl],
            lvl, t_lane, t_lane)
        state = state.replace(
            C_prime=out.C_prime,
            Ws=state.Ws + (out.W,),
            Cs_self=state.Cs_self + (out.C_self,),
            Cs_buddy=state.Cs_buddy + (out.C_buddy,),
            tops=state.tops + (out.is_top,),
        )

    return state.replace(cursor=next_sweep_point(point, geom.n_panels, L))


def finalize(comm, state: SweepState):
    """Deposit the last panel and assemble the sweep outputs:
    ``(R, factors, bundles)`` in the layout of ``CAQRResult(
    collect_bundles=True)``. The caller's state is not consumed."""
    assert state.cursor is None, f"sweep not complete: at {state.cursor}"
    state = _deposit_panel(comm, state, state.geom.n_panels - 1)
    factors = PanelFactors(*(torch.stack(xs) for xs in zip(*state.factors)))
    bundles = RecoveryBundle(*(torch.stack(xs) for xs in zip(*state.bundles)))
    R = assemble_R(comm, torch.stack(state.R_rows), state.geom)
    return R, factors, bundles


def deposit_boundary(comm, state: SweepState):
    """Flush the pending deposit at a panel boundary and return
    ``(state, r)``, ``r`` the number of fully deposited panels. Legal only
    with the cursor at a leaf point or past the end (then do not also call
    ``finalize``, which would run the same deposit again)."""
    if state.cursor is None:
        state = _deposit_panel(comm, state, state.geom.n_panels - 1)
        return state, state.geom.n_panels
    k, phase, _ = state.cursor
    assert phase == PHASE_LEAF, f"not at a panel boundary: {state.cursor}"
    if k > 0:
        state = _deposit_panel(comm, state, k - 1)
    return state, k


def run_steps(comm, state: SweepState, max_points: Optional[int] = None
              ) -> SweepState:
    """Iterate ``sweep_step`` up to ``max_points`` times (or to completion)."""
    n = 0
    while state.cursor is not None and (max_points is None or n < max_points):
        state = sweep_step(comm, state)
        n += 1
    return state


def panel_points(geom: SweepGeometry) -> int:
    """Sweep points per panel: leaf + L butterfly + L trailing levels."""
    return 1 + 2 * geom.levels


def run_panel_fused(comm, state: SweepState) -> SweepState:
    """Execute all of panel ``k``'s points (leaf + L tsqr + L trailing) as
    one launch of K6 (``kernels.fused_sweep``); on CPU tensors its plain
    version runs. The cursor must sit at a leaf point. The result is
    bit-identical to ``run_steps(comm, state, panel_points(geom))``; the
    panel-(k-1) deposit runs outside the kernel, as ``sweep_step`` runs it.
    There is no fallback to stepping: on a CUDA tensor K6 runs or raises.
    """
    from repro_torch.kernels import ops

    point = state.cursor
    assert point is not None, "sweep already complete; call finalize"
    k, phase, _lvl = point
    assert phase == PHASE_LEAF, (
        f"fused execution starts at a leaf boundary, cursor is at {point}")
    if not isinstance(comm, SimComm):
        raise NotImplementedError("the fused panel runs in the SimComm layout")
    geom = state.geom
    L = state.levels

    if k > 0:
        state = _deposit_panel(comm, state, k - 1)
    window = state.A[..., k * geom.b:]
    res = ops.fused_panel(window, k, b=geom.b, m_loc_pad=geom.m_loc_pad,
                          levels=L)
    last = sweep_point(k, PHASE_TRAILING, L - 1)
    return state.replace(
        window=window,
        leaf_Y=res["leaf_Y"], leaf_T=res["leaf_T"],
        R_leaf=res["R_leaf"], R_carry=res["R_carry"],
        Y2s=tuple(res["level_Y2"]), Ts=tuple(res["level_T"]),
        level_Y2=res["level_Y2"], level_T=res["level_T"],
        C_local=res["C_local"], C_prime=res["C_prime"],
        Ws=tuple(res["Ws"]), Cs_self=tuple(res["Cs_self"]),
        Cs_buddy=tuple(res["Cs_buddy"]), tops=tuple(res["tops"]),
        cursor=next_sweep_point(last, geom.n_panels, L),
    )


# -- lane-axis bookkeeping ---------------------------------------------------

_FACTORS_AXES = PanelFactors(
    leaf_Y=0, leaf_T=0, level_Y2=1, level_T=1,
    row_start=0, active=0, target=0,
)
_BUNDLE_AXES = RecoveryBundle(W=1, C_self=1, C_buddy=1, Y2=1, T=1,
                              self_was_top=1)


def state_lane_axes(state: SweepState) -> SweepState:
    """A ``SweepState``-shaped structure of ints: the lane-axis position of
    every array leaf (SimComm layout); -1 for the parity slots, which have
    none. Drives death-masking (``repro_torch.ft.driver.obliterate_state``)."""

    def like(field, ax):
        return _map(lambda _: ax, getattr(state, field))

    axes = {f: like(f, 0) for f in _ARRAY_FIELDS}
    for f in ("level_Y2", "level_T"):
        axes[f] = like(f, 1)
    axes["factors"] = tuple(_FACTORS_AXES for _ in state.factors)
    axes["bundles"] = tuple(_BUNDLE_AXES for _ in state.bundles)
    axes["code"] = like("code", -1)
    return state.replace(**axes)


# -- host serialization (the SweepState wire format, DESIGN.md §9) -----------


def _wire_excluded(version: int) -> Tuple[str, ...]:
    assert version in (1, 2), f"unknown sweep-state wire version {version}"
    return _V1_EXCLUDED_FIELDS if version == 1 else ()


def flat_arrays(state: SweepState, version: int = WIRE_VERSION
                ) -> Dict[str, Any]:
    """The state's array leaves keyed by their wire-format names
    (``"A"``, ``"Y2s/0"``, ``"factors/3/leaf_Y"``, ...), in field order."""
    flat: Dict[str, Any] = {}
    for f in _ARRAY_FIELDS:
        if f in _wire_excluded(version):
            continue
        v = getattr(state, f)
        if v is None:
            continue
        if isinstance(v, tuple):
            for i, entry in enumerate(v):
                if isinstance(entry, (PanelFactors, RecoveryBundle)):
                    for fld, x in zip(entry._fields, entry):
                        flat[f"{f}/{i}/{fld}"] = x
                else:
                    flat[f"{f}/{i}"] = entry
        else:
            flat[f] = v
    return flat


def replace_arrays(state: SweepState, arrays: Dict[str, Any]) -> SweepState:
    """``state`` with the leaves named in ``arrays`` (``flat_arrays`` keys)
    replaced; every other leaf is kept."""
    fields: Dict[str, Any] = {}
    for f in _ARRAY_FIELDS:
        v = getattr(state, f)
        if isinstance(v, tuple):
            entries = []
            for i, entry in enumerate(v):
                if isinstance(entry, (PanelFactors, RecoveryBundle)):
                    entries.append(type(entry)(*(
                        arrays.get(f"{f}/{i}/{fld}", x)
                        for fld, x in zip(entry._fields, entry))))
                else:
                    entries.append(arrays.get(f"{f}/{i}", entry))
            fields[f] = tuple(entries)
        elif v is not None:
            fields[f] = arrays.get(f, v)
    return state.replace(**fields)


def sweep_state_to_host(state: SweepState, version: int = WIRE_VERSION
                        ) -> Dict[str, np.ndarray]:
    """Flatten a state to named numpy arrays plus a ``__meta__`` JSON
    record (geometry, cursor, per-field structure): the JAX package's
    wire format. Inverse: ``sweep_state_from_host``."""
    excluded = _wire_excluded(version)
    arrays = {k: np.asarray(torch.as_tensor(v).detach().cpu().numpy())
              for k, v in flat_arrays(state, version).items()}
    meta = {
        "version": version,
        "geom": [int(g) for g in state.geom],
        "cursor": list(state.cursor) if state.cursor is not None else None,
        "none_fields": [
            f for f in _ARRAY_FIELDS
            if f not in excluded
            and not isinstance(getattr(state, f), tuple)
            and getattr(state, f) is None
        ],
        "tuple_lens": {
            f: len(getattr(state, f)) for f in _ARRAY_FIELDS
            if f not in excluded and isinstance(getattr(state, f), tuple)
        },
    }
    arrays["__meta__"] = np.asarray(json.dumps(meta))
    return arrays


def sweep_state_from_host(arrays: Dict[str, np.ndarray], device="cuda"
                          ) -> SweepState:
    """Rebuild a ``SweepState`` from ``sweep_state_to_host`` output of
    either package (e.g. a loaded ``.npz``), with its tensors on
    ``device``; raises without CUDA unless ``device="cpu"``."""
    meta = json.loads(str(arrays["__meta__"]))
    version = meta["version"]
    assert version in (1, 2), meta
    geom = SweepGeometry(*meta["geom"])
    cursor = tuple(meta["cursor"]) if meta["cursor"] is not None else None
    dev = resolve_device(device)

    def leaf(key):
        # np.array copies, so read-only arrays (np.asarray of a jax.Array) work
        return torch.from_numpy(np.array(arrays[key])).to(dev)

    fields: Dict[str, Any] = {}
    for f in _ARRAY_FIELDS:
        if f in _wire_excluded(version) or f in meta["none_fields"]:
            fields[f] = None
        elif f in meta["tuple_lens"]:
            n = meta["tuple_lens"][f]
            group = {"factors": PanelFactors, "bundles": RecoveryBundle}.get(f)
            if group is not None:
                fields[f] = tuple(
                    group(**{fld: leaf(f"{f}/{i}/{fld}")
                             for fld in group._fields})
                    for i in range(n))
            else:
                fields[f] = tuple(leaf(f"{f}/{i}") for i in range(n))
        else:
            fields[f] = leaf(f)
    return SweepState(geom=geom, cursor=cursor, **fields)
