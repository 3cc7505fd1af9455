"""State carried between the JAX package and the port, as numpy arrays
(no JAX counterpart; the JAX side passes ``np.asarray`` of its fields).

A factorization is the state: ``result_to_arrays`` flattens a
``CAQRResult`` into one dict keyed by field name (``R``, the
``PanelFactors`` fields and, when present, the ``RecoveryBundle``
fields), and ``result_from_arrays`` builds the port's ``CAQRResult`` from
such a dict — for example one made from a JAX ``CAQRResult`` — so one
package's factorization can be replayed by the other's ``caqr_apply_qt``.
Arrays keep the JAX layout: leading panel axis, then the lane axis.

A sweep state crosses as its wire format (``sweep_state_to_host`` of
either package: named numpy arrays plus a ``__meta__`` record), MDS parity
slots included: ``sweep_state_from_arrays`` builds the port's
``SweepState`` from one. An elastic outcome crosses as its fields:
``elastic_result_from_fields`` takes R as numpy and the event, transition
and world records as any objects with the reference's attributes.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch

from repro_torch.core.caqr import CAQRResult, PanelFactors
from repro_torch.core.trailing import RecoveryBundle
from repro_torch.ft.driver import RecoveryEvent
from repro_torch.ft.elastic import ElasticSweepResult, LaneWorld, TransitionEvent
from repro_torch.ft.online.state import SweepState, sweep_state_from_host
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


def sweep_state_from_arrays(arrays: Mapping[str, np.ndarray], device="cuda"
                            ) -> SweepState:
    """The port's ``SweepState`` from a wire-format dict of either package
    (its ``code`` parity slots included), tensors on ``device``."""
    return sweep_state_from_host(dict(arrays), device=device)


def _world(w) -> LaneWorld:
    return LaneWorld(n_slots=int(w.n_slots), live=tuple(bool(x) for x in w.live),
                     col_base=int(w.col_base))


def elastic_result_from_fields(R, events: Iterable, transitions: Iterable,
                               world, device="cuda") -> ElasticSweepResult:
    """The port's ``ElasticSweepResult`` from an elastic outcome's fields:
    ``R`` a numpy array, ``events`` objects with ``point``, ``lane``,
    ``reads`` and ``elapsed_s``, ``transitions`` objects with the
    ``TransitionEvent`` fields, and ``world`` one with ``n_slots``,
    ``live`` and ``col_base`` (for example those of a JAX
    ``ElasticSweepResult``)."""
    return ElasticSweepResult(
        R=_from_numpy(R, resolve_device(device)),
        events=[RecoveryEvent(point=tuple(e.point), lane=int(e.lane),
                              reads=dict(e.reads),
                              elapsed_s=float(e.elapsed_s)) for e in events],
        transitions=[TransitionEvent(
            kind=t.kind, frontier=int(t.frontier),
            lanes=tuple(int(x) for x in t.lanes),
            adopter=None if t.adopter is None else int(t.adopter),
            world_before=_world(t.world_before),
            world_after=_world(t.world_after)) for t in transitions],
        world=_world(world))


def _from_numpy(x, dev: torch.device) -> torch.Tensor:
    # np.array copies, so read-only arrays (np.asarray of a jax.Array) work.
    return torch.from_numpy(np.array(x)).to(dev)
