"""Block-shape autotuner of the port's kernels, keyed by the card (port
of ``src/repro/kernels/autotune.py``).

For each **cell**, an (op, geometry, dtype, variant) tuple, ``tune`` times
every candidate of the op's tunable knobs on the card (CUDA events after a
warm-up, the median of ``reps``) and records the winner. The candidates
are only knobs that change no bit of the result, since the port's bitwise
contracts (the two lanes of a butterfly pair equal, a lane's bits
independent of its launch, REBUILD equal to failure-free) must hold
whatever a cache holds; ``tune`` checks every candidate's output against
the static default's bit for bit and raises if one differs.

Tunables per op (``candidates``):
  * ``wy_apply`` (K2) and ``stacked_apply`` (K4) up to 128 columns: the
    column tile ``bn`` of ``backend.TILE_BNS``; the static default is
    ``backend.tile_bn``. Above 128 the ``(bn, kbs)`` pair of the products
    of ``kernels/wide.py`` (tile and k range; the static default is
    ``wide.gemm_plan`` for each product).
  * ``panel_qr`` (K1) and ``stacked_qr`` (K3): nothing (``[{}]``). K1's
    team size is a function of (m, b) alone so that K1, K5 and K6 agree
    bit for bit (``backend.team_blocks``); tuning it would break REBUILD.
  * ``panel_qr_apply`` (K5) and ``fused_panel`` (K6): nothing; their
    wrappers take the column tile from ``backend.tile_bn`` and expose no
    knob.
A cell's geometry holds the lane count P first, since ``tile_bn`` and
``gemm_plan`` depend on it: ``wy_apply`` (P, m, b, n), ``stacked_apply``
(P, b, n), ``panel_qr`` (P, m, b), ``stacked_qr`` (P, b). The variant is
``"cuda"``; the plain version (CPU tensors) has no knob, so ``tune`` on
the CPU returns None.

Consultation: ``kernels/ops.py`` calls ``lookup`` for K2 and K4 on every
CUDA call that gives no tile (a dict probe, nothing when no cell is
loaded) and passes the winner to the kernel's wrapper. Tuning is never
implicit: ``tune`` and ``tune_all`` run only when called.

Tuning on the card and writing the cache::

    python -m repro_torch.kernels.autotune [--out PATH] [--reps N]

Persistence: ``save``/``load`` round-trip the winners through a JSON
cache in the reference's format::

    {"version": 1,
     "cells": {"<backend_fingerprint>": {
         "wy_apply|8x4096x128x4096|float32|cuda": {
             "params": {"bn": 64}, "us": 1812.4, "static_us": 1865.0},
         ...}}}

keyed by ``backend.backend_fingerprint()`` (the card, its compute
capability and SM count, the torch and CUDA versions, and a digest of the
kernel sources). A file from another card, build or package (the JAX
package's cells among them) is valid but inert: foreign fingerprints are
kept on save and ignored on load. ``REPRO_AUTOTUNE_CACHE=<path>`` names a
cache to load at the first lookup; the default path is
``build/autotune.json`` in the checkout.
"""
from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import backend, build, wide

CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
VARIANT = backend.ENGINE_CUDA

# Winners for this process's fingerprint: cell key -> {"params", "us", ...}.
_CELLS: Dict[str, Dict] = {}
# Cells of other fingerprints, carried through load -> save round trips.
_FOREIGN: Dict[str, Dict[str, Dict]] = {}
_ENV_LOADED = False

# The ops whose column tile may be tuned (K2, K4) and the widest b of their
# one-block engine (wy_apply.MAX_B, stacked_qr.MAX_B).
TILED = ("wy_apply", "stacked_apply")
MAX_B = wide.NB


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


def cell_key(op: str, geometry: Sequence[int], dtype, variant: str) -> str:
    """``op|geom|dtype|variant``, the reference's key."""
    geom = "x".join(str(int(g)) for g in geometry)
    return f"{op}|{geom}|{_dtype_name(dtype)}|{variant}"


def current_variant(op: str, device="cuda") -> str:
    """The flavor ``op`` runs on ``device``: the kernel on a CUDA device,
    the plain version on the CPU."""
    kind = torch.device(device).type
    return VARIANT if kind == "cuda" else backend.ENGINE_PLAIN


def _ensure_env_loaded() -> None:
    global _ENV_LOADED
    if _ENV_LOADED:
        return
    _ENV_LOADED = True
    path = os.environ.get(CACHE_ENV, "").strip()
    if path and os.path.exists(path):
        load(path)


def lookup(op: str, geometry: Sequence[int], dtype,
           variant: str = VARIANT) -> Dict[str, int]:
    """Tuned params for the cell, or ``{}`` (the static defaults)."""
    _ensure_env_loaded()
    if not _CELLS:
        return {}
    rec = _CELLS.get(cell_key(op, geometry, dtype, variant))
    return dict(rec["params"]) if rec else {}


def clear() -> None:
    """Drop every winner in memory (tests)."""
    global _ENV_LOADED
    _CELLS.clear()
    _FOREIGN.clear()
    _ENV_LOADED = True  # a cleared tuner stays cleared; load() re-fills


def candidates(op: str, variant: str = VARIANT,
               geometry: Sequence[int] = ()) -> List[Dict[str, int]]:
    """The search space of one (op, variant), the static defaults (``{}``)
    first. Above 128 columns (``b`` of ``geometry``) K2 and K4 take their
    products' tile and k range: ``kbs`` from no split down to an eighth of
    the block sums of the route's longest sum (K2's Y^T C sums over m,
    K4's products over b: geometry[1] either way)."""
    if variant != VARIANT or op not in TILED:
        return [{}]
    b = (geometry[2] if op == "wy_apply" else geometry[1]) if geometry else 0
    if b <= MAX_B:
        return [{}] + [{"bn": bn} for bn in backend.TILE_BNS]
    nblk = wide.kblocks(geometry[1])
    kbss = sorted({max(1, nblk >> i) for i in range(4)}, reverse=True)
    return [{}] + [{"bn": bn, "kbs": kbs} for bn in wide.TILES for kbs in kbss]


def _median_us(fn, reps: int) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after a warm-up."""
    fn()
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) * 1e3)
    return statistics.median(samples)


def _inputs(op: str, geometry: Sequence[int], dtype, device) -> tuple:
    """One cell's inputs, from a seeded numpy generator, on ``device``."""
    rng = np.random.default_rng(0)

    def arr(*shape, scale=1.0, triu=False):
        x = rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)
        x = np.triu(x) if triu else x
        return torch.from_numpy(x).to(device=device, dtype=dtype)

    if op == "wy_apply":
        P, m, b, n = geometry
        return arr(P, m, b, scale=0.1), arr(P, b, b, scale=0.1, triu=True), arr(P, m, n)
    if op == "stacked_apply":
        P, b, n = geometry
        return (arr(P, b, b, scale=0.1, triu=True),
                arr(P, b, b, scale=0.1, triu=True), arr(P, b, n), arr(P, b, n))
    if op == "panel_qr":
        P, m, b = geometry
        return (arr(P, m, b),)
    if op == "stacked_qr":
        P, b = geometry
        return arr(P, b, b, triu=True), arr(P, b, b, triu=True)
    raise ValueError(f"no tuning runner for op {op!r}")


def _runner(op: str, inputs: tuple, params: Dict[str, int]):
    """A nullary callable for one candidate: the kernel's wrapper with the
    candidate's knobs forced (never the tuner's lookup)."""
    from repro_torch.kernels import panel_qr as _panel
    from repro_torch.kernels import stacked_qr as _stacked
    from repro_torch.kernels import wy_apply as _wy

    kw = {k: params.get(k) for k in ("bn", "kbs")}
    fn = {"wy_apply": lambda: _wy.wy_apply(*inputs, **kw),
          "stacked_apply": lambda: _stacked.stacked_apply(*inputs, **kw),
          "panel_qr": lambda: _panel.panel_qr(*inputs, 0),
          "stacked_qr": lambda: _stacked.stacked_qr(*inputs)}
    return fn[op]


def _same_bits(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def tune(op: str, geometry: Sequence[int], dtype=None, reps: int = 5,
         variant: Optional[str] = None, device="cuda") -> Optional[Dict]:
    """Time every candidate of one cell on ``device`` and record the
    winner in memory. Returns ``{"params", "us", "static_us"}`` (the
    winner's median microseconds and the static defaults'), or None on the
    CPU, where the plain version has nothing to tune. Raises if a
    candidate's output differs from the static defaults' in a bit."""
    dtype = torch.float32 if dtype is None else dtype
    if variant is None:
        variant = current_variant(op, device)
    if variant != VARIANT:
        return None
    inputs = _inputs(op, geometry, dtype, backend.resolve_device(device))
    static = None
    best: Optional[Tuple[float, Dict[str, int]]] = None
    for params in candidates(op, variant, geometry):
        fn = _runner(op, inputs, params)
        out = fn()
        if static is None:
            static = out
        elif not _same_bits(out, static):
            raise AssertionError(f"{op} {tuple(geometry)}: candidate {params} "
                                 "changes the result's bits")
        del out
        us = _median_us(fn, reps)
        if not params:
            static_us = us
        if best is None or us < best[0]:
            best = (us, params)
    record = {"params": best[1], "us": round(best[0], 2),
              "static_us": round(static_us, 2)}
    _ensure_env_loaded()
    _CELLS[cell_key(op, geometry, dtype, variant)] = record
    return record


# The cells the tall sweep (32768 x 4096 over P = 8, b = 128) and its b = 256
# sweep launch: K2 on the first panel's window and on a late one (w = 512),
# K4 on the first panel's C', and both above 128 columns.
DEFAULT_CELLS = (
    ("wy_apply", (8, 4096, 128, 4096)),
    ("wy_apply", (8, 4096, 128, 512)),
    ("stacked_apply", (8, 128, 4096)),
    ("wy_apply", (8, 4096, 256, 4096)),
    ("stacked_apply", (8, 256, 4096)),
)


def tune_all(cells=DEFAULT_CELLS, dtype=None, reps: int = 5,
             device="cuda") -> Dict[str, Dict]:
    """Tune a set of cells; returns {cell_key: winner record}."""
    dtype = torch.float32 if dtype is None else dtype
    out = {}
    for op, geometry in cells:
        rec = tune(op, geometry, dtype=dtype, reps=reps, device=device)
        if rec is not None:
            out[cell_key(op, geometry, dtype, current_variant(op, device))] = rec
    return out


def _default_path() -> str:
    return os.environ.get(CACHE_ENV, "").strip() or str(
        build.BUILD_DIR.parent / "autotune.json")


def save(path: Optional[str] = None) -> str:
    """Write every known winner (ours and the foreign fingerprints') as
    JSON; returns the path."""
    path = path or _default_path()
    cells = dict(_FOREIGN)
    if _CELLS:
        cells[backend.backend_fingerprint()] = _CELLS
    payload = {"version": 1, "cells": cells}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
    return path


def load(path: Optional[str] = None) -> int:
    """Load a cache file; adopt only the cells of this process's
    fingerprint (the others are kept for saving, never consulted).
    Returns the number of cells adopted."""
    global _ENV_LOADED
    path = path or _default_path()
    with open(path) as f:
        payload = json.load(f)
    if payload.get("version") != 1:
        raise ValueError(f"{path}: autotune cache version "
                         f"{payload.get('version')!r}, expected 1")
    _ENV_LOADED = True
    fp = backend.backend_fingerprint()
    adopted = 0
    for fingerprint, cells in payload.get("cells", {}).items():
        if fingerprint == fp:
            _CELLS.update(cells)
            adopted += len(cells)
        else:
            _FOREIGN.setdefault(fingerprint, {}).update(cells)
    return adopted


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Tune DEFAULT_CELLS on the card "
                                             "and write the cache.")
    ap.add_argument("--out", default=None, help="cache path (default: "
                    f"${CACHE_ENV} or build/autotune.json)")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    for key, rec in tune_all(reps=args.reps).items():
        print(json.dumps({"cell": key, **rec}))
    print(save(args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
