"""Householder QR with compact-WY representation (port of
``src/repro/core/householder.py``).

Same conventions as the JAX package: ``Q = I - Y T Y^T`` with Y
unit-lower-trapezoidal, T upper triangular, ``tau = diag(T)``, and the
masked formulation (rows above ``row_start`` frozen, column ``j`` pivots
at ``row_start + j``, degenerate columns give ``tau = 0``).

Every function here is batched: arrays may carry any number of leading
axes (the SimComm lane axis), and ``row_start`` may be a scalar or one
value per batch entry. The public entry points (``householder_qr_masked``,
``stacked_qr``, ``apply_qt``, ``stacked_apply_qt``, ``panel_qr_apply``)
dispatch through ``repro_torch.kernels.ops`` — batched calls too, since
the lane axis is a grid dimension of every port kernel. The
``_``-prefixed pure forms are the plain versions the kernels are held
against (``kernels/ref.py`` binds them).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.backend import to_device


class WY(NamedTuple):
    """Compact-WY factorization of an m x n panel: Q = I - Y T Y^T."""

    Y: torch.Tensor  # (..., m, n) unit lower trapezoidal
    T: torch.Tensor  # (..., n, n) upper triangular
    R: torch.Tensor  # (..., n, n) upper triangular


class StackedQR(NamedTuple):
    """QR of two stacked b x b upper triangles: Y = [I; Y2], Y2 upper
    triangular; only Y2 and T are stored."""

    Y2: torch.Tensor  # (..., b, b)
    T: torch.Tensor   # (..., b, b)
    R: torch.Tensor   # (..., b, b)


def _rows_at(X: torch.Tensor, start: torch.Tensor, count: int) -> torch.Tensor:
    """``X[..., start:start+count, :]`` per batch entry, with the start
    clamped to ``[0, m - count]`` as ``lax.dynamic_slice`` clamps it."""
    m = X.shape[-2]
    start = start.clamp(0, m - count)
    rows = start[..., None] + torch.arange(count, device=X.device)
    idx = rows[..., None].expand(*rows.shape, X.shape[-1])
    return torch.gather(X, -2, idx)


def _row_start(row_start, batch, device) -> torch.Tensor:
    rs = to_device(row_start, device).to(torch.int64)
    return rs.expand(batch) if rs.dim() == 0 else rs.reshape(batch)


def _house(x: torch.Tensor, pivot: torch.Tensor, mask: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Householder reflector of the masked vector ``x`` (..., m): returns
    ``(v, tau)`` with ``v[pivot] == 1`` (dropped when the pivot lies past
    the last row, as JAX drops an out-of-range scatter), ``v`` zero outside
    ``mask``, and beta = -sign(x0)*||x|| with sign(0) = +1."""
    m = x.shape[-1]
    x = torch.where(mask, x, torch.zeros_like(x))
    x0 = torch.gather(x, -1, pivot.clamp(0, m - 1)[..., None])[..., 0]
    sigma = torch.sum(x * x, -1) - x0 * x0
    norm_x = torch.sqrt(x0 * x0 + sigma)
    sign = torch.where(x0 >= 0, 1.0, -1.0).to(x.dtype)
    beta = -sign * norm_x
    degenerate = norm_x <= 1e-30
    denom = torch.where(degenerate, torch.ones_like(x0), x0 - beta)
    v = torch.where(mask, x / denom[..., None], torch.zeros_like(x))
    at_pivot = torch.arange(m, device=x.device) == pivot[..., None]
    v = torch.where(at_pivot, torch.ones_like(v), v)
    tau = torch.where(degenerate, torch.zeros_like(x0), (beta - x0) / beta)
    return v, tau


def build_t(Y: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Forward T recurrence over G = Y^T Y:
    T[:j, j] = -tau_j T[:j, :j] (Y[:, :j]^T y_j), T[j, j] = tau_j."""
    n = Y.shape[-1]
    G = Y.mT @ Y
    idx = torch.arange(n, device=Y.device)
    T = torch.zeros_like(G)
    for j in range(n):
        g = torch.where(idx < j, G[..., :, j], torch.zeros_like(G[..., :, j]))
        col = -taus[..., j:j + 1] * (T @ g[..., None])[..., 0]
        col = torch.where(idx < j, col, torch.zeros_like(col))
        col[..., j] = taus[..., j]
        T[..., :, j] = col
    return T


def _householder_qr_masked(A: torch.Tensor, row_start) -> WY:
    """Plain masked Householder QR of the active rows of ``A`` (..., m, n):
    rows ``row_start <= i < m`` are active; R is rows
    ``[row_start, row_start + n)`` of the transformed matrix (start clamped
    to ``m - n``)."""
    m, n = A.shape[-2:]
    batch = A.shape[:-2]
    rs = _row_start(row_start, batch, A.device)
    rows = torch.arange(m, device=A.device)
    A_ = A.clone()
    Y = torch.zeros_like(A)
    taus = torch.zeros(*batch, n, dtype=A.dtype, device=A.device)
    for j in range(n):
        pivot = rs + j
        mask = rows >= pivot[..., None]
        v, tau = _house(A_[..., j], pivot, mask)
        w = (v[..., None, :] @ A_)[..., 0, :]
        A_ = A_ - tau[..., None, None] * v[..., :, None] * w[..., None, :]
        Y[..., j] = v
        taus[..., j] = tau
    R = torch.triu(_rows_at(A_, rs, n)[..., :n, :n])
    return WY(Y=Y, T=build_t(Y, taus), R=R)


def _apply_qt(Y: torch.Tensor, T: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    W = T.mT @ (Y.mT @ C)
    return C - Y @ W


def _stacked_qr(R_top: torch.Tensor, R_bot: torch.Tensor) -> StackedQR:
    b = R_top.shape[-1]
    S = torch.cat([torch.triu(R_top), torch.triu(R_bot)], dim=-2)
    wy = _householder_qr_masked(S, 0)
    return StackedQR(Y2=torch.triu(wy.Y[..., b:, :]), T=wy.T, R=wy.R)


def _stacked_apply_qt(sq: StackedQR, C_top: torch.Tensor, C_bot: torch.Tensor):
    W = sq.T.mT @ (C_top + sq.Y2.mT @ C_bot)
    return C_top - W, C_bot - sq.Y2 @ W, W


# -- kernel-dispatched entry points -----------------------------------------


def householder_qr_masked(A: torch.Tensor, row_start) -> WY:
    """Masked panel QR (K1 on a CUDA tensor, the plain form on the CPU)."""
    from repro_torch.kernels import ops

    return WY(*ops.panel_qr(A, row_start))


def householder_qr(A: torch.Tensor) -> WY:
    """QR of the full matrix (row_start = 0)."""
    return householder_qr_masked(A, 0)


def apply_qt(Y: torch.Tensor, T: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Q^T C = C - Y (T^T (Y^T C)) (K2 on a CUDA tensor)."""
    from repro_torch.kernels import ops

    return ops.wy_apply(Y, T, C)


def stacked_qr(R_top: torch.Tensor, R_bot: torch.Tensor) -> StackedQR:
    """QR of [R_top; R_bot], both upper triangular (K3 on a CUDA tensor)."""
    from repro_torch.kernels import ops

    return StackedQR(*ops.stacked_qr(R_top, R_bot))


def stacked_apply_qt(sq: StackedQR, C_top: torch.Tensor, C_bot: torch.Tensor):
    """The paper's W form of the stacked Q^T (K4 on a CUDA tensor):
    W = T^T (C_top + Y2^T C_bot); returns (C_top - W, C_bot - Y2 W, W)."""
    from repro_torch.kernels import ops

    return ops.stacked_apply(sq.Y2, sq.T, C_top, C_bot)


def panel_qr_apply(W: torch.Tensor, row_start, b: int):
    """Fused leaf step: panel QR of ``W[..., :b]`` + Q^T applied to the
    whole window + C' row extraction, one launch (K5 on a CUDA tensor, the
    unfused composition of the pure forms on the CPU). Returns
    ``(wy, C, C_prime)``."""
    from repro_torch.kernels import ops

    Y, T, R, C, Cp = ops.panel_qr_apply(W, row_start, b)
    return WY(Y=Y, T=T, R=R), C, Cp


def apply_q(Y: torch.Tensor, T: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Q C = C - Y (T (Y^T C)) (plain matmuls, as in the JAX package)."""
    W = T @ (Y.mT @ C)
    return C - Y @ W


def q_dense(Y: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Materialize Q = I - Y T Y^T (testing / small sizes only)."""
    m = Y.shape[-2]
    return torch.eye(m, dtype=Y.dtype, device=Y.device) - Y @ (T @ Y.mT)


def stacked_apply_q(sq: StackedQR, C_top: torch.Tensor, C_bot: torch.Tensor):
    """Apply the stacked Q (not transposed) to [C_top; C_bot]."""
    W = sq.T @ (C_top + sq.Y2.mT @ C_bot)
    return C_top - W, C_bot - sq.Y2 @ W
