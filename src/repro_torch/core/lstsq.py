"""Least squares on top of FT-CAQR: min ||Ax - b|| (port of
``src/repro/core/lstsq.py``).

x = R1^{-1} (Q^T b)[:k], k = min(m, n), with Q^T replayed from the stored
panel factors. Tall or ragged systems get the least-squares solution;
wide systems (m < n, A = Q [R1 R2]) get the *basic* solution x = [x1; 0]
with R1 x1 = (Q^T b)[:m], which solves A x = b exactly for a full-row-rank
A but is not the minimum-norm solution.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.caqr import (
    CAQRResult,
    caqr_apply_qt,
    caqr_factorize,
    sweep_geometry,
)
from repro_torch.kernels.backend import to_device


def caqr_lstsq(A_local: torch.Tensor, b_local: torch.Tensor, comm,
               panel_width: int, result: Optional[CAQRResult] = None):
    """Solve min ||Ax - b|| for block-row-distributed A (P, m_loc, n) and
    b (P, m_loc, q) (under ``AxisComm`` each rank's (1, m_loc, n) and
    (1, m_loc, q)). Returns x (n, q), the same on every lane. ``result``
    reuses a factorization of A at the same panel width."""
    m_loc, n = comm.local_shape(A_local)
    geom = sweep_geometry(comm.axis_size(), m_loc, n, panel_width)
    if result is None:
        result = caqr_factorize(A_local, comm, panel_width)
    if result.factors.leaf_T.shape[-1] != panel_width:
        raise ValueError("precomputed result was factorized at a different "
                         "panel width")
    if (result.factors.leaf_Y.shape[-2] != geom.m_loc_pad
            or tuple(result.R.shape[-2:]) != (geom.k, n)):
        raise ValueError("precomputed result was factorized at a different "
                         "geometry")
    Qtb = caqr_apply_qt(b_local, result.factors, comm)
    # R row r deposits at padded global row r: lane r // m_loc_pad, local
    # row r % m_loc_pad. Each lane scatters its rows below k into a (k, q)
    # block and one psum collects them (every row has one nonzero term,
    # so the sum is exact), replicated on every lane.
    K, m_pad = geom.k, geom.m_loc_pad
    rows = comm.axis_index().to(torch.int64)[:, None] * m_pad + torch.arange(
        m_pad)
    lane, local = torch.nonzero(rows < K, as_tuple=True)
    dev = Qtb.device
    lane, local = to_device(lane, dev), to_device(local, dev)
    out = Qtb.new_zeros((Qtb.shape[0], K, Qtb.shape[-1]))
    out[lane, to_device(rows, dev)[lane, local]] = Qtb[lane, local]
    Qtb_top = comm.psum(out)[0]
    R = result.R[0]
    x1 = torch.linalg.solve_triangular(R[:, :K], Qtb_top, upper=True)
    if n > K:
        x1 = torch.cat([x1, x1.new_zeros((n - K, x1.shape[-1]))], dim=0)
    return x1
