"""Production meshes (port of ``src/repro/launch/mesh.py``).

Functions, so that importing this module spawns nothing; a mesh spawns
its ranks only when a body runs on it (``repro_torch.dist.compat``).
"""
from __future__ import annotations

from repro_torch.dist import compat


def _mk(shape, axes, device):
    return compat.make_mesh(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16x16 single pod (256 chips) or 2x16x16 two pods (512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


def make_qr_mesh(*, multi_pod: bool = False, device="cuda"):
    """1-D lane mesh for the paper's own CAQR workload (one lane per chip;
    the tree spans the whole pod or both pods)."""
    n = 512 if multi_pod else 256
    return _mk((n,), ("qr",), device)


def make_small_mesh(n_data: int = 4, n_model: int = 2, device="cuda"):
    """Test-sized mesh."""
    return _mk((n_data, n_model), ("data", "model"), device)
