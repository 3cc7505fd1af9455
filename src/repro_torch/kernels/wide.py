"""K1-K4 at panel widths above 128: the blocked routes (counterpart of the
reference's kernels at any b: ``src/repro/kernels/panel_qr.py`` takes any
(m, b) in one block, and ``src/repro/kernels/ops.py`` pads b for K2-K4).

The port's b <= 128 bodies (``csrc/qr_common.cuh``) fix their thread
layouts at 128 columns. A wider call is composed of launches of
hand-written kernels, never of ``torch.matmul`` or ``torch.geqrf``:

* K1 (``panel_qr_blocked``): the panel in sub-panels of at most
  ``NB = 128`` columns, each through K1's team body at row start
  ``row_start + c0``, each sub-panel's Q^T applied to the columns right of
  it by K2's wide route below (not K2's b <= 128 engine, whose one
  sequential chain over the m rows moved the later reflectors of an
  ill-conditioned Muon momentum by 0.14; ``csrc/wide.cu`` sums in three
  levels), T joined block by block as
  ``T[:c0, c0:] = -T[:c0, :c0] (Y[:, :c0]^T Y_j) T_j`` (the products in
  ``csrc/wide.cu``), and R taken from rows ``[rs', rs' + b)`` of the
  updated panel, ``rs' = clamp(row_start, 0, m - b)`` as the reference
  clamps it;
* K2 (``wy_apply_wide``): ``Z = Y^T C``, ``W = T^T Z``, ``out = C - Y W``,
  three products of ``csrc/wide.cu`` that read all of T, so any T gives
  the function of the plain version, not only Y's own;
* K3 (``stacked_qr_wide``): K1's blocked route on the stacked triangles
  ``[triu(R_top); triu(R_bot)]`` at row start 0, whose reflectors keep the
  stack's exact zeros, so ``Y[:b]`` is I and ``Y2 = Y[b:]`` upper
  triangular (twice the FLOPs of a structured QR);
* K4 (``stacked_apply_wide``): ``inner = C_top + Y2^T C_bot``, then
  ``W = T^T inner`` and ``C_top - W`` from one product (its epilogue
  stores both), ``C_bot - Y2 W``.

At bf16 K1 and K3 run one launch of ``csrc/panel_qr_wide_bf16.cu`` (the
f32 blocked QR on a widened copy, its outputs rounded at the end, since it
reads its own Y and T back: the f32 kernel on the widened inputs rounded
once), and the products of K2 and K4 take each operand at its own type
(``csrc/wide_bf16.cu``) and run on the tensor cores (``wgmma``, the order
contract of ``csrc/wgmma_bf16.cuh``): the intermediates Z, W and inner stay
f32, as the reference's tile programs accumulate in f32, an f32 operand is
split into two bf16 halves (``ref.split_bf16``), and only the outputs are
rounded (K4's W after ``C_bot - Y2 W`` has read it in f32).
``gemm_split`` emulates those products in f32 for the tests.

Each route is a function of its sub-kernels (``qr``, ``apply``, ``gemm``),
so the CPU tests run the composition with the plain bodies (``PLAIN``)
against the unblocked plain versions. On the card the wrappers in
``panel_qr.py``, ``wy_apply.py`` and ``stacked_qr.py`` pass the CUDA
bodies. Every sub-kernel's sums run in a fixed order that depends on the
shape alone (each sub-panel's team is ``backend.team_blocks(m, b_j)``; the
products' order is the contract of ``csrc/wide_common.cuh``, which
``gemm_order`` runs as loops), so
a lane's bits are the same in any launch, and a wide call counts as one
launch of its op in ``backend.LAUNCHES``; its kernels' launches are in
``backend.SUB_LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import backend, build, ref

# The widest panel of K1's team body (QR_MAX_B in csrc/qr_common.cuh):
# the columns of a sub-panel of the blocked K1 (panel_qr.MAX_B is this).
NB = 128

_P, _L, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_GEMM = [_P, _L, _L, _L] * 6 + [_I] * 5

# The tiles of csrc/wide.cu: bn -> (rows, columns) of a block's outputs.
TILES = {128: (128, 128), 64: (64, 64), 32: (64, 32)}
# Terms of one block sum (csrc/wide_common.cuh): a split of k falls on
# these boundaries.
BLOCK_K = 256
# Blocks that fill the card once, the target of the shape rule: a constant
# of the design (the H100's 132 SMs), never read from the card, so a shape
# gets one plan everywhere.
WAVE = 132
# Block sums a sum needs before a split can pay for its second launch.
SPLIT_MIN = 8


@functools.cache
def _kernel(sfx: str):
    if sfx == "f32":
        return build.bind("wide", "wide_gemm_f32", _GEMM + [_I, _I, _P, _P])
    return build.bind("wide_bf16", "wide_gemm_bf16", _GEMM + [_I] * 3 + [_P, _P])


@functools.cache
def _order_kernel():
    return build.bind("wide", "wide_gemm_order_f32", _GEMM + [_P])


@functools.cache
def _round_kernel():
    return build.bind("wide_bf16", "wide_round_bf16", [_P, _P, _L, _P])


def _as3(x: torch.Tensor, what: str) -> torch.Tensor:
    if (x.device.type != "cuda" or x.dtype not in (torch.float32, torch.bfloat16)
            or x.dim() not in (2, 3)):
        raise ValueError(f"wide_gemm: {what} must be a CUDA float32 or bfloat16 "
                         f"tensor of rank 2 or 3, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    return x.unsqueeze(0) if x.dim() == 2 else x


# The bf16 entry's type bits (WB_* in csrc/wide_common.cuh), an operand a
# bit: A, B, D (or E), out, out2.
_WB = (1, 2, 4, 8, 16)


def _types(*xs) -> int:
    """The type bits of (A, B, D or E, out, out2); 0 when all are f32."""
    return sum(bit for bit, x in zip(_WB, xs)
               if x is not None and x.dtype == torch.bfloat16)


def _ptr(x: Optional[torch.Tensor]):
    """An operand's pointer and (lane, row, column) strides; null for None."""
    return (None, 0, 0, 0) if x is None else (x.data_ptr(), *x.stride())


def kblocks(K: int) -> int:
    """Block sums of a K-term sum."""
    return -(-K // BLOCK_K)


def gemm_plan(P: int, M: int, N: int, K: int):
    """(bn, kbs) of a product over P lanes of (M x K) (K x N), from the
    shape alone: the 128 x 128 tile when the lanes' tiles fill the card
    once, else 64 x 64; and, when a lane has few 64 x 64 tiles and the sum
    at least ``SPLIT_MIN`` block sums, k split into ranges of ``kbs``
    block sums so that about a wave of blocks runs (``kbs`` = kblocks(K):
    no split). Neither changes a bit of the result. The split does not
    look at P."""
    def tiles(bn):
        bm, bc = TILES[bn]
        return -(-M // bm) * -(-N // bc)

    bn = 128 if P * tiles(128) >= WAVE else 64
    nblk, t = kblocks(K), tiles(64)
    parts = (min(nblk, -(-WAVE // t))
             if 0 < t and 2 * t <= WAVE and nblk >= SPLIT_MIN else 1)
    return bn, -(-nblk // max(parts, 1)) if nblk else 1


def _operands(A, B, D, out, minuend, out_dtype=None):
    """The lane-axis views of gemm's operands, checked, the second output
    (for ``minuend``, in its dtype) and the operands' type bits. A new
    ``out`` takes ``out_dtype``, by default A's."""
    A3, B3 = _as3(A, "A"), _as3(B, "B")
    P, M, K = A3.shape
    N = B3.shape[-1]
    if B3.shape != (P, K, N):
        raise ValueError(f"wide_gemm: shapes {tuple(A.shape)} and "
                         f"{tuple(B.shape)} do not conform")
    if out is None:
        out = torch.empty(*A.shape[:-1], N, device=A.device,
                          dtype=A.dtype if out_dtype is None else out_dtype)
    O3 = _as3(out, "out")
    D3 = None if D is None else _as3(D, "D")
    E3 = None if minuend is None else _as3(minuend, "minuend")
    diff = None if minuend is None else torch.empty(
        out.shape, device=out.device, dtype=minuend.dtype)
    O23 = None if diff is None else _as3(diff, "out2")
    for x in (O3, D3, E3, O23):
        if x is not None and x.shape != (P, M, N):
            raise ValueError(f"wide_gemm: an output-shaped operand is "
                             f"{tuple(x.shape)}, not {(P, M, N)}")
    if D3 is not None and E3 is not None and D3.dtype != E3.dtype:
        raise ValueError("wide_gemm: D and the minuend differ in dtype")
    types = _types(A3, B3, D3 if D3 is not None else E3, O3, O23)
    args = (*_ptr(A3), *_ptr(B3), *_ptr(D3), *_ptr(O3), *_ptr(E3), *_ptr(O23))
    return args, (P, M, N, K), out, diff, types


def _bf16_kind(types: int, D, minuend) -> None:
    """Raise for a mix of element types no bf16 route runs: the
    combinations of ``gemm_bf16_kind`` (csrc/wide_common.cuh), a missing
    operand's bit set."""
    full = (types | (0 if D is not None or minuend is not None else 4)
            | (0 if minuend is not None else 16))
    kinds = {1 | 2 | 4 | 16: minuend is None, 1 | 4 | 16: D is None,
             1 | 4 | 8 | 16: minuend is None}
    if not kinds.get(full, False):
        raise NotImplementedError(
            f"wide_gemm: no kernel takes the element types {types:05b} "
            "(bits: A, B, D/E, out, out2 from the right; 1 = bf16)")


def gemm(A: torch.Tensor, B: torch.Tensor, D: Optional[torch.Tensor] = None,
         *, sub: bool = False, out: Optional[torch.Tensor] = None,
         bn: Optional[int] = None, minuend: Optional[torch.Tensor] = None,
         kbs: Optional[int] = None, out_dtype: Optional[torch.dtype] = None):
    """``D -/+ A B`` per lane on the card (``csrc/wide.cu``): A (P, M, K),
    B (P, K, N), D (P, M, N) or None (then ``-/+ A B``), or the same
    without the lane axis; any strides, so ``Y.mT`` or a column block is
    passed without a copy. Writes into ``out`` (a view, any strides) when
    given, else into a new contiguous tensor. ``bn`` (a key of ``TILES``)
    and ``kbs`` (block sums a k range; below ``kblocks(K)`` the sum is
    split, with its block sums in scratch) default to ``gemm_plan``; they
    do not change a bit. With ``minuend`` E (shaped as D) it returns
    ``(out, E - A B)``, the second from the same sum by a second store of
    the kernel's epilogue, in E's dtype. Each operand is float32 or
    bfloat16 (``out_dtype``, by default A's, for a new ``out``): at f32
    throughout ``wide_gemm_f32`` (FFMA); else ``wide_gemm_bf16``, which
    takes the bf16 routes' three mixes (a bf16 A and B into a float out; a
    bf16 A times a float B into a float out, with a bf16 second store; a
    bf16 A times a float B from a bf16 D into a bf16 out) on the tensor
    cores, an f32 B split in two bf16 halves (``gemm_split`` emulates it)."""
    args, (P, M, N, K), out, diff, types = _operands(A, B, D, out, minuend,
                                                     out_dtype)
    if types:
        _bf16_kind(types, D, minuend)
    plan_bn, plan_kbs = gemm_plan(P, M, N, K)
    bn = plan_bn if bn is None else bn
    kbs = plan_kbs if kbs is None else kbs
    if bn not in TILES or kbs < 1:
        raise ValueError(f"wide_gemm: tile {bn} is not one of {tuple(TILES)}, "
                         f"or k range {kbs} < 1")
    if M and N:
        split = kbs < kblocks(K)
        part = (torch.empty(kblocks(K) * P * M * N, device=A.device,
                            dtype=torch.float32) if split else None)
        pt = None if part is None else part.data_ptr()
        if types:
            err = _kernel("bf16")(*args, P, M, N, K, int(sub), types, bn, kbs,
                                  pt, backend.stream_ptr(A))
        else:
            err = _kernel("f32")(*args, P, M, N, K, int(sub), bn, kbs, pt,
                                 backend.stream_ptr(A))
        build.check(err, "wide_gemm")
        backend.count_sub("wide_gemm_kernel")
        if split:
            backend.count_sub("wide_gemm_reduce")
    return out if diff is None else (out, diff)


def narrow(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``: itself when it is, else (a float tensor on the
    card, to bf16) rounded to nearest even by ``wide_round_bf16``, counted
    in ``backend.SUB_LAUNCHES``; on the CPU (the plain bodies) ``x.to``."""
    if x.dtype == dtype:
        return x
    if x.device.type != "cuda":
        return x.to(dtype)
    if x.dtype != torch.float32 or dtype != torch.bfloat16:
        raise ValueError(f"narrow: float32 to bfloat16 only, got {x.dtype} "
                         f"to {dtype}")
    x = x.contiguous()
    y = torch.empty(x.shape, device=x.device, dtype=dtype)
    build.check(_round_kernel()(x.data_ptr(), y.data_ptr(), x.numel(),
                                backend.stream_ptr(x)), "wide_round_bf16")
    backend.count_sub("wide_round_bf16")
    return y


def gemm_order(A, B, D=None, *, sub=False, out=None, minuend=None):
    """``gemm`` through the oracle of its summation order
    (``wide_gemm_order_f32``: one thread an element, the order as loops),
    float32 operands only (the bf16 products sum inside the tensor cores'
    steps, which no oracle reproduces: ``gemm_split`` is theirs). For the
    tests, which hold every f32 instantiation of the tile routine to it bit
    for bit; no path calls it."""
    args, (P, M, N, K), out, diff, types = _operands(A, B, D, out, minuend)
    if types:
        raise ValueError("wide_gemm_order: float32 operands only")
    if M and N:
        build.check(_order_kernel()(*args, P, M, N, K, int(sub),
                                    backend.stream_ptr(A)), "wide_gemm_order")
    return out if diff is None else (out, diff)


def gemm_split(A, B, D=None, *, sub=False, minuend=None, out_dtype=None,
               scale=False):
    """The bf16 mixes of ``gemm`` as the wgmma kernels compute them,
    emulated in f32 torch.matmul on the widened operands: a bf16 A times a
    bf16 B, or times an f32 B split in two bf16 halves
    (``ref.split_matmul``); each output rounded once to its dtype (out:
    ``out_dtype``, by default A's; the second store: E's). With ``scale``
    also each output's term magnitudes (|D| + |A| |B|, |E| + |A| |B|), the
    scale of ``ref.bf16_ulp_ok``. For the tests, which hold the kernels to
    it within one bf16 ulp (f32 outputs within f32 round-off); no path
    calls it."""
    AB = (ref.split_matmul(A, B) if B.dtype == torch.float32
          else A.float() @ B.float())
    if D is not None:
        res = D.float() - AB if sub else D.float() + AB
    else:
        res = -AB if sub else AB
    outs = (res.to(A.dtype if out_dtype is None else out_dtype),)
    if minuend is not None:
        outs += ((minuend.float() - AB).to(minuend.dtype),)
    if scale:
        aAB = A.float().abs() @ B.float().abs()
        scales = tuple(aAB if X is None else X.float().abs() + aAB
                       for X in (D, minuend)[:len(outs)])
        return outs, scales
    return outs if minuend is not None else outs[0]


def gemm_plain(A, B, D=None, *, sub=False, out=None, bn=None, minuend=None,
               kbs=None, out_dtype=None):
    """The plain version of ``gemm``."""
    AB = A @ B
    res = (D - AB if sub else D + AB) if D is not None else (-AB if sub else AB)
    if out is not None:
        res = out.copy_(res)
    elif out_dtype is not None:
        res = res.to(out_dtype)
    return res if minuend is None else (res, minuend - AB)


def panel_qr_blocked(A: torch.Tensor, rs: torch.Tensor, *, qr, apply, gemm):
    """(Y, T, R) of the masked panel QR of A (P, m, b), m >= b, row starts
    ``rs`` (P,) integers, in sub-panels of at most ``NB`` columns:
    ``qr(A_j, rs_j)`` the QR of a sub-panel, ``apply(Y_j, T_j, C)`` its Q^T
    on the columns right of it, ``gemm`` the T join's products."""
    P, m, b = A.shape
    rs = rs.to(torch.int64).reshape(-1).expand(P)
    # R's rows, rs' = clamp(rs, 0, m - b) on
    rows = rs.clamp(0, m - b)[:, None] + torch.arange(b, device=A.device)
    Y = A.new_empty(P, m, b)
    T = A.new_zeros(P, b, b)
    R = A.new_empty(P, b, b)
    cur = A  # columns [c0, b) of the panel as the sub-panels before c0 left them
    for c0 in range(0, b, NB):
        bj = min(NB, b - c0)
        rs_j = rs + c0
        Yj, Tj, Rj = qr(cur[..., :bj], rs_j)
        # R's columns [c0, c0 + bj): a row above this sub-panel's first pivot
        # keeps what the sub-panels before it left there; the others are
        # rows of the sub-panel's own R, whose start it clamps to m - bj
        kept = cur[..., :bj].gather(-2, rows[..., None].expand(P, b, bj))
        own = (rows - rs_j.clamp(0, m - bj)[:, None]).clamp(0, bj - 1)
        made = Rj.gather(-2, own[..., None].expand(P, b, bj))
        R[..., c0:c0 + bj] = torch.where((rows < rs_j[:, None])[..., None],
                                         kept, made)
        Y[..., c0:c0 + bj] = Yj
        T[..., c0:c0 + bj, c0:c0 + bj] = Tj
        if c0:  # T[:c0, c0:c0+bj] = -T[:c0, :c0] (Y[:, :c0]^T Y_j) T_j
            G = gemm(Y[..., :c0].mT, Yj)
            gemm(T[..., :c0, :c0], gemm(G, Tj), sub=True,
                 out=T[..., :c0, c0:c0 + bj])
        if c0 + bj < b:
            cur = apply(Yj, Tj, cur[..., bj:])
    return Y, T, R.triu()


def wy_apply_wide(Y, T, C, *, gemm, bn=None, kbs=None):
    """Q^T C = C - Y (T^T (Y^T C)) for any b; Y (P, m, b), T (P, b, b),
    C (P, m, n); Y^T C and W float32, the result in C's dtype. ``bn`` and
    ``kbs`` (the products' tile and k range) apply to each of the three
    products; None leaves each its ``gemm_plan``."""
    f32 = torch.float32
    W = gemm(T.mT, gemm(Y.mT, C, bn=bn, kbs=kbs, out_dtype=f32), bn=bn, kbs=kbs,
             out_dtype=f32)
    return gemm(Y, W, C, sub=True, bn=bn, kbs=kbs)


def cuda_apply(Y, T, C):
    """Q^T C between two sub-panels of the blocked K1 on the card: K2's wide
    route, the three-level sums of ``csrc/wide.cu``."""
    return wy_apply_wide(Y, T, C, gemm=gemm)


def stacked_qr_wide(R_top, R_bot, *, qr, apply, gemm):
    """(Y2, T, R) of QR([triu(R_top); triu(R_bot)]) for any b, through the
    blocked K1 at row start 0."""
    P, b, _ = R_top.shape
    S = torch.cat([R_top.triu(), R_bot.triu()], dim=-2)
    Y, T, R = panel_qr_blocked(S, torch.zeros(P, dtype=torch.int64,
                                              device=S.device),
                               qr=qr, apply=apply, gemm=gemm)
    return Y[..., b:, :].triu(), T, R


def stacked_apply_wide(Y2, T, C_top, C_bot, *, gemm, bn=None, kbs=None):
    """(C_top - W, C_bot - Y2 W, W), W = T^T (C_top + Y2^T C_bot), for any
    b; every entry of Y2 and T is read, as the plain version reads it.
    The inner sum and W are float32 (``C_bot - Y2 W`` reads W in float, as
    the reference computes it); the outputs, W too, in C_top's dtype.
    ``bn`` and ``kbs`` as in ``wy_apply_wide``."""
    f32 = torch.float32
    W, top = gemm(T.mT, gemm(Y2.mT, C_bot, C_top, bn=bn, kbs=kbs, out_dtype=f32),
                  bn=bn, kbs=kbs, minuend=C_top, out_dtype=f32)
    bot = gemm(Y2, W, C_bot, sub=True, bn=bn, kbs=kbs)
    return top, bot, narrow(W, C_top.dtype)


# The plain bodies: the blocked routes composed of the plain versions.
PLAIN = dict(qr=ref.panel_qr, apply=ref.wy_apply, gemm=gemm_plain)
