"""FT-CAQR: fault-tolerant QR of general matrices (port of
``src/repro/core/caqr.py``).

1-D block-row layout: lane ``i`` owns rows ``[i*m_loc, (i+1)*m_loc)`` of a
``(P*m_loc, n)`` matrix, held as one ``(P, m_loc, n)`` tensor. The sweep
factorizes panels left to right: the leaf QR of every lane (K1, one
launch), the FT butterfly (K3 per level), the leaf apply on the live
window (K2) and the trailing combine (K4 per level). Panel ``k``'s tree is
rooted at the owner of global rows ``[k*b, (k+1)*b)``; consumed lanes give
zero leaves and pass-through combines.

General shapes run at the zero-padded ``sweep_geometry`` (exact for every
op in this family); wide matrices factorize the left ``min(m, n)`` columns
and carry the rest as the ``R2`` block. ``caqr_apply_qt`` replays the
stored per-panel factors against any conforming matrix.
``caqr_factorize_batched`` and ``caqr_apply_qt_batched`` run a stack of
independent same-shape problems. ``caqr_factorize_spmd`` runs the same
sweep in one rank of a process group (``AxisComm``: one lane a process).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.comm import axis_comm, lane_block
from repro_torch.core.householder import householder_qr_masked
from repro_torch.core.trailing import RecoveryBundle, trailing_update_ft
from repro_torch.core.tsqr import DistTSQRFactors, ft_tsqr_combine
from repro_torch.kernels.backend import resolve_device, to_device


class PanelFactors(NamedTuple):
    """Implicit-Q factors of one panel, per lane (leading panel axis after
    the sweep, then the lane axis)."""

    leaf_Y: torch.Tensor    # (P, m_loc, b)
    leaf_T: torch.Tensor    # (P, b, b)
    level_Y2: torch.Tensor  # (L, P, b, b) — zeroed == pass-through
    level_T: torch.Tensor   # (L, P, b, b)
    row_start: torch.Tensor  # (P,) int32
    active: torch.Tensor     # (P,) bool
    target: torch.Tensor     # (P,) int32, the tree root (replicated)


class CAQRResult(NamedTuple):
    R: torch.Tensor                        # (P, min(m, n), n), replicated
    factors: PanelFactors                  # stacked over panels
    bundles: Optional[RecoveryBundle]      # stacked over panels, if asked


class SweepGeometry(NamedTuple):
    """Static geometry of a general-shape sweep (Python ints): per-lane rows
    padded to a multiple of b (>= b), a ragged last panel rounded up to
    width b, ``n_panels`` over the left ``min(m, n)`` columns, and ``k`` =
    ``min(m, n)`` rows of the returned R."""

    P: int
    b: int
    m_loc: int
    n: int
    m_loc_pad: int
    n_work: int
    n_panels: int
    k: int

    @property
    def aligned(self) -> bool:
        return self.m_loc_pad == self.m_loc and self.n_work == self.n

    @property
    def levels(self) -> int:
        assert self.P & (self.P - 1) == 0, self.P
        return self.P.bit_length() - 1


def _ceil_to(x: int, q: int) -> int:
    return -(-x // q) * q


def sweep_geometry(P: int, m_loc: int, n: int, b: int) -> SweepGeometry:
    """Padded sweep geometry for a general ``(P*m_loc) x n`` factorization."""
    assert m_loc >= 1 and n >= 1 and b >= 1, (m_loc, n, b)
    m_loc_pad = _ceil_to(m_loc, b)
    k = min(P * m_loc, n)
    n_panels = -(-k // b)
    n_work = max(n, n_panels * b)
    assert n_panels * b <= P * m_loc_pad
    return SweepGeometry(P=P, b=b, m_loc=m_loc, n=n, m_loc_pad=m_loc_pad,
                         n_work=n_work, n_panels=n_panels, k=k)


def pad_to_geometry(comm, A_local: torch.Tensor, geom: SweepGeometry):
    """Zero-pad each lane's block to the sweep's working shape (the same
    tensor when the geometry is aligned)."""
    dr, dc = geom.m_loc_pad - geom.m_loc, geom.n_work - geom.n
    if dr == 0 and dc == 0:
        return A_local
    return F.pad(A_local, (0, dc, 0, dr))


def block_row_layout(A, P: int, m_loc: Optional[int] = None,
                     n: Optional[int] = None, device="cuda") -> torch.Tensor:
    """Distribute a whole ``(m, q)`` numpy matrix into the block-row layout
    ``(P, m_loc, n)`` on ``device``: rows zero-padded to ``P*m_loc`` and
    split contiguously, columns zero-padded to ``n``. ``m_loc`` defaults to
    ``ceil(m / P)``, ``n`` to ``q``. Raises without CUDA unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    A = np.asarray(A)
    m, q = A.shape
    if m_loc is None:
        m_loc = -(-m // P)
    if n is None:
        n = q
    if m > P * m_loc or q > n:
        raise ValueError(f"matrix ({m}, {q}) exceeds the ({P}x{m_loc}, {n}) "
                         "bucket")
    out = np.zeros((P * m_loc, n), A.dtype)
    out[:m, :q] = A
    return torch.from_numpy(out.reshape(P, m_loc, n)).to(dev)


def panel_geometry(comm, k: int, b: int, m_loc: int):
    """Bookkeeping of panel ``k``: ``(col0, t_lane, row_start, active)``
    with per-lane (CPU) ``row_start`` and ``active``."""
    idx = comm.axis_index()
    col0 = k * b
    t_lane = col0 // m_loc
    row_start_raw = col0 - idx * m_loc
    active = row_start_raw < m_loc
    row_start = row_start_raw.clamp(0, m_loc - b)
    return col0, t_lane, row_start, active


def lane_geometry(k: int, b: int, m_loc: int, lane: int):
    """``panel_geometry`` for one concrete lane, as Python scalars."""
    col0 = k * b
    row_start_raw = col0 - lane * m_loc
    active = row_start_raw < m_loc
    row_start = min(max(row_start_raw, 0), m_loc - b)
    return col0, col0 // m_loc, row_start, active


def assemble_R(comm, R_rows: torch.Tensor, geom: SweepGeometry) -> torch.Tensor:
    """Stack the per-panel replicated R row-blocks (n_panels, P, b, n_work)
    into the (P, k, n) upper-trapezoidal R (P the comm's local lanes)."""
    P = comm.local_lanes()
    rows = geom.n_panels * geom.b
    R = R_rows.transpose(0, 1).reshape(P, rows, geom.n_work)
    return torch.triu(R)[:, :geom.k, :geom.n]


def advance_columns(comm, A_cur: torch.Tensor, window_next: torch.Tensor,
                    col0: int) -> torch.Tensor:
    """Reattach the updated live window to the untouched dead columns."""
    return torch.cat([A_cur[..., :col0], window_next], dim=-1)


def extract_r_rows(comm, C_final: torch.Tensor, t_lane: int, col0: int):
    """The new R rows live at lane ``t_lane``'s final C'; replicate them
    (the FT broadcast) and left-pad back to full-width columns."""
    idx = comm.axis_index()
    R_rows = comm.psum(comm.where(idx == t_lane, C_final,
                                  torch.zeros_like(C_final)))
    return _pad_cols(R_rows, col0)


def _pad_cols(x: torch.Tensor, left: int) -> torch.Tensor:
    """Left-pad the last (column) axis with zeros."""
    return F.pad(x, (left, 0)) if left else x


def pad_bundle(bundle: RecoveryBundle, col0: int) -> RecoveryBundle:
    """Left-pad a window-width recovery bundle to full width."""
    return bundle._replace(W=_pad_cols(bundle.W, col0),
                           C_self=_pad_cols(bundle.C_self, col0),
                           C_buddy=_pad_cols(bundle.C_buddy, col0))


def make_panel_factors(comm, leaf_Y, leaf_T, level_Y2, level_T, row_start,
                       active, t_lane) -> PanelFactors:
    dev = leaf_Y.device
    return PanelFactors(
        leaf_Y=leaf_Y, leaf_T=leaf_T, level_Y2=level_Y2, level_T=level_T,
        row_start=to_device(row_start, dev).to(torch.int32),
        active=to_device(active, dev),
        target=torch.full((comm.local_lanes(),), t_lane, dtype=torch.int32,
                          device=dev),
    )


def _panel_step(comm, b: int, collect_bundles: bool, k: int, A_cur,
                windowed: bool):
    """One panel of the sweep. ``windowed`` restricts the trailing update
    to the live window ``A[..., k*b:]`` (the dead columns to its left are
    not touched); per-column arithmetic is the same, so R and the
    window's bundle slices equal the full-width step's."""
    m_loc = comm.local_shape(A_cur)[0]
    col0, t_lane, row_start, active = panel_geometry(comm, k, b, m_loc)
    C = A_cur[..., col0:] if windowed else A_cur
    panel = A_cur[..., col0:col0 + b]

    wy = householder_qr_masked(panel, row_start)
    leaf_Y = comm.where(active, wy.Y, torch.zeros_like(wy.Y))
    leaf_T = comm.where(active, wy.T, torch.zeros_like(wy.T))
    R_leaf = comm.where(active, wy.R, torch.zeros_like(wy.R))
    level_Y2, level_T, _ = ft_tsqr_combine(comm, R_leaf, t_lane,
                                           active_threshold=t_lane)
    factors = DistTSQRFactors(leaf_Y, leaf_T, level_Y2, level_T, R_leaf)
    C_next, bundle, C_final = trailing_update_ft(
        C, factors, comm, target=t_lane, row_start=row_start, active=active,
        dead_threshold=t_lane)
    if windowed:
        A_next = advance_columns(comm, A_cur, C_next, col0)
        R_rows = extract_r_rows(comm, C_final, t_lane, col0)
        if collect_bundles:
            bundle = pad_bundle(bundle, col0)
    else:
        A_next = C_next
        R_rows = extract_r_rows(comm, C_final, t_lane, 0)
    pf = make_panel_factors(comm, leaf_Y, leaf_T, level_Y2, level_T,
                            row_start, active, t_lane)
    return A_next, (pf, R_rows, bundle if collect_bundles else None)


def _stack(items, cls):
    return cls(*(torch.stack(xs) for xs in zip(*items)))


def caqr_factorize(A_local: torch.Tensor, comm, panel_width: int,
                   collect_bundles: bool = False, use_scan: bool = True
                   ) -> CAQRResult:
    """FT-CAQR sweep of a general matrix held as (P, m_loc, n). Returns the
    replicated R, (P, min(m, n), n), and the implicit-Q panel factors.

    use_scan: True = every panel updates the full width (the JAX package's
        ``lax.scan`` form, here a Python loop); False = the windowed sweep,
        which updates only the live window ``A[..., k*b:]``. Both give the
        same R and factors. (The JAX package's separate ``windowed`` flag
        only mattered next to ``lax.scan``, so it is not ported.)
    """
    b = panel_width
    m_loc, n = comm.local_shape(A_local)
    geom = sweep_geometry(comm.axis_size(), m_loc, n, b)
    A_cur = pad_to_geometry(comm, A_local, geom)
    windowed = not use_scan
    outs = []
    for k in range(geom.n_panels):
        A_cur, out = _panel_step(comm, b, collect_bundles, k, A_cur, windowed)
        outs.append(out)
    factors = _stack([o[0] for o in outs], PanelFactors)
    R_rows = torch.stack([o[1] for o in outs])
    bundles = (_stack([o[2] for o in outs], RecoveryBundle)
               if collect_bundles else None)
    return CAQRResult(R=assemble_R(comm, R_rows, geom), factors=factors,
                      bundles=bundles)


def caqr_apply_qt(B_local: torch.Tensor, factors: PanelFactors, comm
                  ) -> torch.Tensor:
    """Apply the implicit Q^T of a CAQR factorization to B (P, m_loc, q).

    Replays every panel's leaf WY and tree combine against B; for B = A it
    reproduces [R; 0]. B is zero-row-padded to the factors' padded rows and
    the padded layout is returned.
    """
    m_fac = factors.leaf_Y.shape[-2]
    m_b = comm.local_shape(B_local)[0]
    if m_b != m_fac:
        assert m_b < m_fac, (m_b, m_fac)
        B_local = F.pad(B_local, (0, 0, 0, m_fac - m_b))
    B = B_local
    for k in range(factors.leaf_Y.shape[0]):
        pf = PanelFactors(*(x[k] for x in factors))
        tgt = int(pf.target[0])
        dist = DistTSQRFactors(pf.leaf_Y, pf.leaf_T, pf.level_Y2, pf.level_T,
                               pf.leaf_T)
        B, _, _ = trailing_update_ft(B, dist, comm, target=tgt,
                                     row_start=pf.row_start, active=pf.active,
                                     dead_threshold=tgt)
    return B


# Batched front end -----------------------------------------------------------


def caqr_factorize_batched(A_batch: torch.Tensor, comm, panel_width: int,
                           **kw) -> CAQRResult:
    """Factorize a stack of independent same-shape problems held as
    (batch, P, m_loc, n). Every field of the returned ``CAQRResult`` gains
    the leading batch axis, as under the JAX package's ``jax.vmap``.

    Each problem runs through ``caqr_factorize`` on its own, so its bits
    equal its solo run; one launch per kernel over batch x P lanes is not
    done here."""
    res = [caqr_factorize(A, comm, panel_width, **kw) for A in A_batch]
    bundles = (None if res[0].bundles is None else
               _stack([r.bundles for r in res], RecoveryBundle))
    return CAQRResult(R=torch.stack([r.R for r in res]),
                      factors=_stack([r.factors for r in res], PanelFactors),
                      bundles=bundles)


def caqr_apply_qt_batched(B_batch: torch.Tensor, factors: PanelFactors, comm
                          ) -> torch.Tensor:
    """Batched companion of ``caqr_apply_qt``: replays a stack of
    factorizations (from ``caqr_factorize_batched``) against a conforming
    stack of right-hand sides, one problem at a time."""
    return torch.stack([
        caqr_apply_qt(B, PanelFactors(*(x[i] for x in factors)), comm)
        for i, B in enumerate(B_batch)])


# SPMD wrapper ----------------------------------------------------------------


def caqr_factorize_spmd(A_local: torch.Tensor, group, panel_width: int,
                        **kw) -> CAQRResult:
    """``caqr_factorize`` in one rank of ``group`` (a process group, None
    for the default group, or an ``AxisComm`` to reuse), on this rank's
    block-row ``(m_loc, n)`` or ``(1, m_loc, n)``. Every rank of the group
    must call it; the result keeps the unit lane axis where the
    ``SimComm`` result carries P."""
    return caqr_factorize(lane_block(A_local), axis_comm(group), panel_width,
                          **kw)
