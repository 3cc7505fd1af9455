"""On-disk training checkpoints (port of ``src/repro/ckpt/save.py``): an
npz of the parameter tree, one of the optimizer state, a json manifest and
a ``LATEST`` pointer, with the JAX package's file names and npz keys (the
``repro_torch.tree`` path strings), so a checkpoint either package writes
restores in the other.

bfloat16 has no numpy dtype: such leaves are written as float32 (exact)
and narrowed back to the template's dtype on restore, which is also what
the JAX package's ``restore`` does with them (``astype``).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _flatten(t) -> Dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in tree.flatten_with_path(t)}


def fill(like, flat: Mapping[str, np.ndarray], device=None):
    """A tree of ``like``'s structure whose leaf at each path is
    ``flat[path]`` as a tensor of the template leaf's dtype, on the
    template leaf's device; a template on the meta device (shapes alone)
    puts it on ``device`` (default: the host)."""
    def leaf(path, t):
        arr = np.asarray(flat[path])
        if arr.dtype.kind not in "biuf":  # e.g. an ml_dtypes bfloat16 array
            arr = arr.astype(np.float32)
        dev = t.device if t.device.type != "meta" else torch.device(device or "cpu")
        return torch.from_numpy(np.array(arr)).to(device=dev, dtype=t.dtype)

    return tree.map_with_path(leaf, like)


def save(directory: str, step: int, params, opt_state, extra: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    tag = f"step_{step:08d}"
    path = os.path.join(directory, tag)
    np.savez(path + ".params.npz", **_flatten(params))
    np.savez(path + ".opt.npz", **_flatten(opt_state))
    manifest = {"step": step, "extra": extra or {}}
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(tag)
    os.replace(os.path.join(directory, "LATEST.tmp"), os.path.join(directory, "LATEST"))
    return tag


def save_async(directory: str, step: int, params, opt_state, extra=None) -> threading.Thread:
    """Snapshot to host memory synchronously, write in the background."""
    params_host = tree.map(_host, params)
    opt_host = tree.map(_host, opt_state)
    t = threading.Thread(
        target=save, args=(directory, step, params_host, opt_host, extra), daemon=True)
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    latest = os.path.join(directory, "LATEST")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        tag = f.read().strip()
    return int(tag.split("_")[1])


def _paths(directory: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(directory)
        assert step is not None, f"no checkpoint in {directory}"
    return os.path.join(directory, f"step_{step:08d}")


def restore(directory: str, params_like, opt_like, step: Optional[int] = None
            ) -> Tuple[Any, Any, Dict]:
    """Restore into the structure (and dtypes, devices) of the templates."""
    path = _paths(directory, step)
    with np.load(path + ".params.npz") as pz, np.load(path + ".opt.npz") as oz:
        params, opt = fill(params_like, pz), fill(opt_like, oz)
    with open(path + ".json") as f:
        manifest = json.load(f)
    return params, opt, manifest


def restore_params(directory: str, params_like, step: Optional[int] = None
                   ) -> Tuple[Any, Dict]:
    """Restore only the parameter tree (+ manifest): no optimizer template
    is needed."""
    path = _paths(directory, step)
    with np.load(path + ".params.npz") as pz:
        params = fill(params_like, pz)
    with open(path + ".json") as f:
        manifest = json.load(f)
    return params, manifest
