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

A model and its optimizer cross as flat dicts keyed by the JAX package's
flattened path strings (``repro.ckpt.save._flatten``, e.g.
``groups/l0/attn/.wq``; the optimizer's ``.step``, ``.mom/embed``):
``params_from_arrays`` and ``opt_state_from_arrays`` build the port's
trees from them, ``params_to_arrays`` and ``opt_state_to_arrays`` are the
inverse. The checkpoint files of ``ckpt/save.py`` hold the same keys.
Every family's leaves cross, the SSM's and RG-LRU's, the encoder's
(``enc_layers/attn/.wq``) and the cross-attention's
(``groups/l0/cross/.wk``) included; each array must have its
``param_template`` shape. Decode caches cross the same way
(``groups/l0/.k``, ``rem0/.v``, an SSM state's ``groups/l0/.h`` and
``.conv``):
``caches_from_arrays`` builds the port's cache tree, shaped as
``init_caches`` shapes it, from a flattened JAX cache tree, so a cache the
JAX package's prefill made can be replayed by the port's ``decode_step``;
``caches_to_arrays`` is the inverse. PowerSGD state and the multi-pod
step's state cross the same way: ``psgd_state_from_arrays`` takes a
flattened ``PowerSGDState`` (``.error/embed``, ``.sketch/lm_head``; the
sketches keep their rank, the skipped leaves their empty arrays),
``pod_state_from_arrays`` a flattened ``PodTrainState`` (``.params/...``,
``.opt_state/...``, ``.psgd/...``, ``.step``). Adafactor's state crosses
as a flattened ``AdafactorState`` (``.step``, ``.vr/embed``, ``.vc/...``;
a leaf that is not factored has an empty ``vc``):
``adafactor_state_from_arrays`` and ``adafactor_state_to_arrays``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch

from repro_torch import tree
from repro_torch.ckpt.save import _flatten, fill
from repro_torch.core.caqr import CAQRResult, PanelFactors
from repro_torch.core.trailing import RecoveryBundle
from repro_torch.ft.driver import RecoveryEvent
from repro_torch.ft.elastic import ElasticSweepResult, LaneWorld, TransitionEvent
from repro_torch.ft.online.state import SweepState, sweep_state_from_host
from repro_torch.kernels.backend import resolve_device
from repro_torch.models.transformer import init_caches, param_template
from repro_torch.optim.adafactor import AdafactorState, adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.caqr_muon import caqr_muon
from repro_torch.optim.powersgd import PowerSGDState
from repro_torch.train.step import PodTrainState


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


def _checked_fill(like, flat: Mapping[str, np.ndarray], what: str, device):
    """``fill`` after checking that every template leaf's array has the
    template's shape."""
    for path, t in tree.flatten_with_path(like):
        got = tuple(np.shape(flat[path]))
        if got != tuple(t.shape):
            raise ValueError(f"{path}: shape {got}, {what} {tuple(t.shape)}")
    return fill(like, flat, resolve_device(device))


def params_from_arrays(flat: Mapping[str, np.ndarray], cfg, device="cuda"):
    """The port's parameter tree for ``cfg`` from arrays keyed by the JAX
    package's path strings (``save._flatten(params)`` of a JAX tree); each
    array must have its ``param_template`` shape."""
    return _checked_fill(param_template(cfg), flat, "template", device)


def params_to_arrays(params) -> Dict[str, np.ndarray]:
    """Numpy arrays of a parameter tree keyed by path string (bfloat16
    widened to float32)."""
    return _flatten(params)


def caches_from_arrays(flat: Mapping[str, np.ndarray], cfg, batch: int,
                       seq_len: int, device="cuda"):
    """The port's decode caches for ``cfg`` at ``(batch, seq_len)`` from
    arrays keyed by the JAX package's path strings (``save._flatten`` of a
    JAX cache tree); each array must have its ``init_caches`` shape."""
    return _checked_fill(init_caches(cfg, batch, seq_len, device="meta"), flat,
                         "decode layout", device)


def caches_to_arrays(caches) -> Dict[str, np.ndarray]:
    """Numpy arrays of a cache tree keyed by path string."""
    return _flatten(caches)


def opt_state_from_arrays(flat: Mapping[str, np.ndarray], params,
                          optimizer: str = "adamw", device=None):
    """The port's ``AdamWState`` (``optimizer="adamw"``), ``MuonState``
    (``"caqr_muon"``) or ``AdafactorState`` (``"adafactor"``) for
    ``params`` from arrays keyed by the JAX
    package's path strings (``save._flatten(opt_state)``); on the
    parameters' device unless ``device`` is given."""
    opt = {"adamw": adamw, "caqr_muon": caqr_muon,
           "adafactor": adafactor}[optimizer]()
    # moments on the meta device take ``dev``; the step count stays on the host
    like = opt.init(tree.map(lambda p: torch.empty_like(p, device="meta"), params))
    dev = (resolve_device(device) if device is not None
           else tree.leaves(params)[0].device)
    return fill(like, flat, dev)


def psgd_state_from_arrays(flat: Mapping[str, np.ndarray], params,
                           device=None) -> PowerSGDState:
    """The port's ``PowerSGDState`` for ``params`` from arrays keyed by
    the JAX package's path strings (``save._flatten(psgd_state)``), float32
    on the parameters' device unless ``device`` is given."""
    meta = tree.map(lambda p: torch.empty((), dtype=torch.float32,
                                          device="meta"), params)
    dev = (resolve_device(device) if device is not None
           else tree.leaves(params)[0].device)
    return fill(PowerSGDState(error=meta, sketch=meta), flat, dev)


def adafactor_state_from_arrays(flat: Mapping[str, np.ndarray], params,
                                device=None) -> AdafactorState:
    """The port's ``AdafactorState`` for ``params`` from a flattened JAX
    ``AdafactorState`` (``save._flatten(state)``), the moments float32 on
    the parameters' device unless ``device`` is given."""
    return opt_state_from_arrays(flat, params, "adafactor", device)


def adafactor_state_to_arrays(state: AdafactorState) -> Dict[str, np.ndarray]:
    """Numpy arrays of an ``AdafactorState`` keyed by path string."""
    return _flatten(state)


def _sub(flat: Mapping[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}


def pod_state_from_arrays(flat: Mapping[str, np.ndarray], cfg,
                          optimizer: str = "adamw", device="cuda"
                          ) -> PodTrainState:
    """The port's ``PodTrainState`` for ``cfg`` from a flattened JAX
    ``PodTrainState`` (``save._flatten(state)``): parameters, the
    ``optimizer``'s state, the PowerSGD state (None when the arrays hold
    none) and the step count."""
    params = params_from_arrays(_sub(flat, ".params/"), cfg, device=device)
    opt = opt_state_from_arrays(_sub(flat, ".opt_state/"), params, optimizer)
    psgd = _sub(flat, ".psgd/")
    return PodTrainState(
        params=params, opt_state=opt,
        psgd=psgd_state_from_arrays(psgd, params) if psgd else None,
        step=torch.tensor(int(np.asarray(flat[".step"])), dtype=torch.int32))


def opt_state_to_arrays(opt_state) -> Dict[str, np.ndarray]:
    """Numpy arrays of an optimizer state keyed by path string."""
    return _flatten(opt_state)


def _from_numpy(x, dev: torch.device) -> torch.Tensor:
    # np.array copies, so read-only arrays (np.asarray of a jax.Array) work.
    return torch.from_numpy(np.array(x)).to(dev)
