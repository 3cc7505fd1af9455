"""State carried between the JAX package and the port, as numpy arrays
(no JAX counterpart; the JAX side passes ``np.asarray`` of its fields).

A factorization is the state: ``result_to_arrays`` flattens a
``CAQRResult`` into one dict keyed by field name (``R``, the
``PanelFactors`` fields and, when present, the ``RecoveryBundle``
fields), and ``result_from_arrays`` builds the port's ``CAQRResult`` from
such a dict — for example one made from a JAX ``CAQRResult`` — so one
package's factorization can be replayed by the other's ``caqr_apply_qt``.
Arrays keep the JAX layout: leading panel axis, then the lane axis.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.caqr import CAQRResult, PanelFactors
from repro_torch.core.trailing import RecoveryBundle
from repro_torch.kernels.backend import resolve_device


def to_tensor(x, device="cuda") -> torch.Tensor:
    """A numpy array (e.g. an input of shape (P, m_loc, n)) as a tensor on
    ``device``; raises without CUDA unless ``device="cpu"``."""
    return _from_numpy(x, resolve_device(device))


def result_from_arrays(arrays: Mapping[str, np.ndarray], device="cuda"
                       ) -> CAQRResult:
    """The port's ``CAQRResult`` from numpy arrays keyed by field name.
    The bundle is built when all its fields are present."""
    dev = resolve_device(device)

    def t(name):
        return _from_numpy(arrays[name], dev)

    factors = PanelFactors(*(t(f) for f in PanelFactors._fields))
    bundles = None
    if all(f in arrays for f in RecoveryBundle._fields):
        bundles = RecoveryBundle(*(t(f) for f in RecoveryBundle._fields))
    return CAQRResult(R=t("R"), factors=factors, bundles=bundles)


def result_to_arrays(result) -> Dict[str, np.ndarray]:
    """Numpy arrays of a ``CAQRResult``'s fields keyed by field name."""
    out = {"R": result.R.cpu().numpy()}
    for group in (result.factors, result.bundles):
        if group is not None:
            out.update({f: x.cpu().numpy() for f, x in zip(group._fields, group)})
    return out


def _from_numpy(x, dev: torch.device) -> torch.Tensor:
    # np.array copies, so read-only arrays (np.asarray of a jax.Array) work.
    return torch.from_numpy(np.array(x)).to(dev)
