"""Device resolution, launch counters and the engine report of the port's
kernels. Counterpart of ``src/repro/kernels/backend.py``.

The JAX package chooses among compiled / interpret / oracle routes and
reads environment kill switches. The port has one rule instead, applied
by ``repro_torch.kernels.ops``: a CPU tensor runs the plain PyTorch
version, a CUDA tensor runs the hand-written CUDA kernel or raises. There
is no switch that sends a CUDA tensor to the plain version, so a kernel
result is never silently a plain one; ``probe_report()`` says which engine
ran each op last, and ``LAUNCHES`` counts the kernel launches.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build

ENGINE_CUDA = "cuda"
ENGINE_PLAIN = "plain"

# The ops with a CUDA kernel: the four of the stepped sweep (K1-K4 of
# PERF.md), the fused leaf (K5) and the whole-panel megakernel (K6).
OPS = ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply",
       "panel_qr_apply", "fused_panel")

# Kernel launches per op; each wrapper adds one where it launches. A call
# at a panel width above 128 (the blocked routes of ``kernels/wide.py``)
# counts as one launch of its op, and the kernels it launches are counted
# in SUB_LAUNCHES, by kernel.
LAUNCHES: Dict[str, int] = {op: 0 for op in OPS}
# The bf16 kernels' share of LAUNCHES, per op.
BF16_LAUNCHES: Dict[str, int] = {op: 0 for op in OPS}
SUB_KERNELS = ("panel_qr_kernel", "wide_gemm_kernel", "wide_gemm_reduce",
               "wide_round_bf16")
SUB_LAUNCHES: Dict[str, int] = {k: 0 for k in SUB_KERNELS}
# The engine that ran each op's most recent call ("cuda" or "plain").
_LAST_ENGINE: Dict[str, str] = {}
# Where the matrix products of each op's CUDA kernels run: the bf16
# kernels of K2 and K4, and of K5/K6 which contain their products, on the
# tensor cores ("wgmma", csrc/wgmma_bf16.cuh); every other kernel on FP32
# FFMA ("ffma").
WGMMA_OPS = ("wy_apply", "stacked_apply", "panel_qr_apply", "fused_panel")
ENGINE_WGMMA, ENGINE_FFMA = "wgmma", "ffma"
# The product engine of each op's most recent CUDA launch.
_LAST_PRODUCTS: Dict[str, str] = {}


def reset_launches() -> None:
    """Set every launch counter to 0 (BF16_LAUNCHES and SUB_LAUNCHES too)."""
    for op in OPS:
        LAUNCHES[op] = 0
        BF16_LAUNCHES[op] = 0
    for k in SUB_KERNELS:
        SUB_LAUNCHES[k] = 0


def count_launch(op: str, dtype: torch.dtype = torch.float32) -> None:
    """One launch of ``op``'s kernel on tensors of ``dtype``."""
    LAUNCHES[op] += 1
    if dtype == torch.bfloat16:
        BF16_LAUNCHES[op] += 1
    _LAST_ENGINE[op] = ENGINE_CUDA
    _LAST_PRODUCTS[op] = product_engine(op, dtype)


def product_engine(op: str, dtype: torch.dtype) -> str:
    """Where the products of ``op``'s CUDA kernel at ``dtype`` run:
    ``ENGINE_WGMMA`` or ``ENGINE_FFMA`` (see ``WGMMA_OPS``)."""
    return (ENGINE_WGMMA if dtype == torch.bfloat16 and op in WGMMA_OPS
            else ENGINE_FFMA)


def count_sub(kernel: str) -> None:
    """One launch of ``kernel`` inside a wide call."""
    SUB_LAUNCHES[kernel] += 1


def note_plain(op: str) -> None:
    _LAST_ENGINE[op] = ENGINE_PLAIN


def products_report() -> Dict[str, Optional[str]]:
    """{op: the product engine of its most recent CUDA launch} (None if
    it has not launched)."""
    return {op: _LAST_PRODUCTS.get(op) for op in OPS}


def probe_report() -> Dict[str, Dict[str, object]]:
    """{op: {"engine": "cuda" | "plain" | None, "launches": n}} — the engine
    of each op's most recent call (None if it has not run)."""
    return {op: {"engine": _LAST_ENGINE.get(op), "launches": LAUNCHES[op]}
            for op in OPS}


# The element types of the CUDA kernels, by the suffix of their C entry
# points (``panel_qr_f32``, ``panel_qr_bf16``, ...). Both take any panel
# width: the b <= 128 bodies and, above them, the blocked routes
# (csrc/panel_qr_wide.cu, csrc/wide.cu and csrc/fused_sweep.cu at f32;
# csrc/panel_qr_wide_bf16.cu, csrc/wide_bf16.cu and csrc/fused_wide_bf16.cu
# at bf16).
KERNEL_SUFFIXES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def kernel_suffix(dtype: torch.dtype) -> str:
    """The suffix of the C entry points that take tensors of ``dtype``:
    "f32" or "bf16". Any other dtype (float16, float64, ...) raises
    NotImplementedError: the CUDA kernels have no instance for it."""
    if dtype not in KERNEL_SUFFIXES:
        raise NotImplementedError(
            f"the CUDA kernels take float32 and bfloat16, got {dtype}")
    return KERNEL_SUFFIXES[dtype]


def kernel_dtype(op: str, *tensors: torch.Tensor) -> str:
    """The kernel suffix of a call's tensors, which must share one dtype
    (ValueError otherwise; NotImplementedError for a dtype no kernel
    takes)."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"{op}: the kernel takes tensors of one dtype, got "
                         f"{sorted(str(d) for d in dtypes)}")
    try:
        return kernel_suffix(dtypes.pop())
    except NotImplementedError as e:
        raise NotImplementedError(f"{op}: {e}") from None


def gram_scratch(P: int, b: int, x: torch.Tensor) -> Optional[torch.Tensor]:
    """The float scratch of P (b x b) beside a bf16 QR's T, where its kernel
    keeps G^T; None at f32, whose kernels keep G^T in T itself."""
    if x.dtype == torch.float32:
        return None
    return torch.empty(P * b * b, device=x.device, dtype=torch.float32)


def ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's data pointer, or None (a null pointer) for None."""
    return None if x is None else x.data_ptr()


def lanes(x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` with a lane axis: a 2-D tensor becomes a batch of one. Checks
    what every kernel wrapper needs: a CUDA f32 or bf16 tensor of rank 2
    or 3 with unit column stride."""
    if x.device.type != "cuda":
        raise ValueError(f"{op}: the kernel takes CUDA tensors, got {x.device}")
    kernel_dtype(op, x)
    if x.dim() not in (2, 3) or x.stride(-1) != 1:
        raise ValueError(f"{op}: expected a (P, rows, cols) or (rows, cols) "
                         f"tensor with unit column stride, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    return x.unsqueeze(0) if x.dim() == 2 else x


def contiguous_lanes(x: torch.Tensor, op: str) -> torch.Tensor:
    x = lanes(x, op)
    if not x.is_contiguous():
        raise ValueError(f"{op}: expected a contiguous tensor, got strides "
                         f"{x.stride()}")
    return x


# Column tiles of K2 and K4 (and of K5/K6's apply phases), widest first.
TILE_BNS = (128, 64, 32)


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_bn(P: int, n: int, sms: int) -> int:
    """The column tile for a launch over P lanes of n columns on a card
    with ``sms`` SMs: the widest tile whose (lane, tile) grid still gives
    every SM a block, else the narrowest. The tile does not change a bit
    of the result (every element is one fixed chain, see
    ``csrc/qr_common.cuh``); it only sets how the work spreads."""
    for bn in TILE_BNS[:-1]:
        if P * -(-n // bn) >= sms:
            return bn
    return TILE_BNS[-1]


def launch_bn(P: int, n: int, x: torch.Tensor, bn: Optional[int]) -> int:
    """``bn`` if given (checked), else ``tile_bn`` for the card of ``x``."""
    if bn is None:
        return tile_bn(P, n, sm_count(x.device.index or 0))
    if bn not in TILE_BNS:
        raise ValueError(f"column tile {bn} is not one of {TILE_BNS}")
    return bn


# K1's lane team (csrc/qr_common.cuh, team_qr): at most TEAM_MAX blocks per
# lane, each with at most SMEM_LIMIT bytes of shared memory (Hopper's limit
# for one block).
TEAM_MAX = 16
SMEM_LIMIT = 232448


def team_rows(m: int, C: int) -> int:
    """Rows of one team block's slab (the last slab may hold fewer)."""
    return -(-m // C)


def team_ld(rows: int) -> int:
    """Leading dimension of a team block's column-major slab
    (``team_ld`` in ``csrc/qr_common.cuh``): a multiple of 4, and 4 more
    than a multiple of 8."""
    r4 = -(-rows // 4) * 4
    return r4 + 4 if r4 % 8 == 0 else r4


def team_smem_bytes(m: int, b: int, C: int, slab_in_smem: bool = True) -> int:
    """Shared memory of one team block (``team_smem_floats`` in
    ``csrc/qr_common.cuh``): two buffers of 2b + 1 exchange slots (padded
    to a multiple of 4) of TEAM_MAX values each; the slab, b + 2 columns of
    ``team_ld`` rows, when it is in shared memory, or else room for the T
    factor's scratch at the end; the block's outgoing values (one buffer of
    slots); then w, the taus, R's diagonal and the column's three scalars
    (padded to 4)."""
    xch = (2 * b + 4) // 4 * 4
    slab = (b + 2) * team_ld(team_rows(m, C)) if slab_in_smem else 0
    t_scratch = b * b + b * (b + 1) + 32 * b  # G^T, T, one product
    return 4 * (2 * xch * TEAM_MAX + max(slab, t_scratch) + xch + 3 * b + 4)


def team_blocks(m: int, b: int) -> int:
    """The team size C of K1 (and of K5/K6's leaf) for an (m x b) panel:
    the smallest power of two up to TEAM_MAX whose slab of
    ``team_rows(m, C)`` rows fits in a block's shared memory, else
    TEAM_MAX (the slabs then live in global scratch). A function of (m, b)
    alone, never of the lane count or the card, so a lane gets the same
    bits in a one-lane REBUILD launch as in a P-lane launch, and K1, K5
    and K6 agree; ``csrc/qr_common.cuh::team_blocks`` is the same rule."""
    C = 1
    while C < TEAM_MAX and team_smem_bytes(m, b, C) > SMEM_LIMIT:
        C *= 2
    return C


def team_slab_in_smem(m: int, b: int, C: int) -> bool:
    return team_smem_bytes(m, b, C) <= SMEM_LIMIT


def backend_fingerprint() -> str:
    """A stable identity of the card and the build of its kernels, the
    autotuner's cache key (``kernels/autotune.py``): the card's name,
    compute capability and SM count, the torch and CUDA versions, and a
    digest of the kernel sources (``build.sources_digest``), so winners
    tuned on another card or for another build of the kernels are never
    consulted. Without a card, a ``cpu:`` fingerprint."""
    src = f"src-{build.sources_digest()}"
    if not torch.cuda.is_available():
        return f"cpu:torch-{torch.__version__}:{src}"
    p = torch.cuda.get_device_properties(torch.cuda.current_device())
    return (f"cuda:{p.name}:sm_{p.major}{p.minor}:{p.multi_processor_count}"
            f"sms:torch-{torch.__version__}:cuda-{torch.version.cuda}:{src}")


def stream_ptr(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def to_device(x, device: torch.device) -> torch.Tensor:
    """``x`` (a tensor or Python data) on ``device``. A host tensor bound
    for the GPU goes through pinned memory with a non-blocking copy: a
    plain ``.to("cuda")`` of pageable memory synchronises the stream, and
    the sweep moves small per-lane bookkeeping tensors every level."""
    x = torch.as_tensor(x)
    if x.device.type != "cpu" or device.type != "cuda":
        return x.to(device)
    return x.pin_memory().to(device, non_blocking=True)


def resolve_device(device="cuda") -> torch.device:
    """The device a numpy entry point puts its tensors on. CUDA is the
    default; asking for it without a GPU raises rather than falling back to
    the CPU (pass ``device="cpu"`` to run there on purpose)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain path on the CPU")
    return dev
