"""Suspend, persist and restore in-flight factorizations (port of
``src/repro/ckpt/sweep.py``).

A ``SweepState`` is the complete loop state of the windowed FT-CAQR sweep
at a recoverable boundary, so writing it to disk suspends the
factorization and loading it in a fresh process resumes it: iterating
``sweep_step`` from the restored state finishes bit-identically to the
uninterrupted run.

Wire format: one ``.npz`` of the flattened named arrays plus a
``__meta__`` JSON record (geometry, cursor, tuple arities), the JAX
package's format (``sweep_state_to_host``). A file either package writes
loads in the other; version 2 (the default) carries the coded parity
slots, version 1 leaves them out.
"""
from __future__ import annotations

import os

import numpy as np

from repro_torch.ft.online.state import (
    SweepState,
    WIRE_VERSION,
    sweep_state_from_host,
    sweep_state_to_host,
)


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_sweep_state(path: str, state: SweepState,
                     version: int = WIRE_VERSION) -> str:
    """Suspend: write a mid-sweep state to ``path`` (``.npz`` appended if
    missing), through ``path + '.tmp'`` and a rename. Returns the path."""
    path = _npz(path)
    arrays = sweep_state_to_host(state, version=version)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return path


def load_sweep_state(path: str, device="cuda") -> SweepState:
    """Resume: load a saved sweep state with its tensors on ``device``;
    raises without CUDA unless ``device="cpu"``."""
    with np.load(_npz(path)) as z:
        arrays = {k: z[k] for k in z.files}
    return sweep_state_from_host(arrays, device=device)
