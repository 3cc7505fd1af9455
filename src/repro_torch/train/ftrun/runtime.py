"""FT training runtime: optimizer-internal FT-CAQR sweeps (port of
``src/repro/train/ftrun/runtime.py``).

``FTTrainer`` splits an optimizer step into three phases:

1. **grad phase** — loss, gradients and the optimizer's moment update,
   through the same builders the monolithic step uses
   (``make_loss_and_grads``, ``muon_moments``);
2. **factorization task loop** (host) — each planned :class:`QRTask`
   runs a full online FT-CAQR sweep on the :class:`QREngine` (K1-K4 on
   the card): runtime detection, REBUILD healing (or the MDS joint
   decode), optionally async double-buffered segments. A lane killed
   mid-step is healed inside the step, so params and the loss curve are
   bit-identical to the failure-free run with no training-level rewind;
3. **finish phase** — ``muon_deltas`` with the engine's Q factors for the
   routed leaves, then the parameter update.

Routings: ``optimizer="caqr_muon"`` (every large Muon slice through the
engine), or ``optimizer="adamw"`` with ``compression_rank > 0``, the
PowerSGD bridge: per-lane gradients compressed through the split
``psgd_project``/``psgd_rfactor``/``psgd_complete`` phases with the
projection's orthonormalization on the engine.

A boundary hook may suspend training mid-sweep (:class:`SuspendSweep`):
the trainer writes the model checkpoint and the in-flight sweep state
(wire v2) and raises :class:`TrainingSuspended`; ``FTTrainer.resume``
continues bit-identically in a fresh trainer.

``phase_s`` accumulates the host seconds of the three phases (the device
is synchronised at the end of each), for the train bench.

``FTRunConfig(use_mesh=True)`` runs every sweep's points over a lane
mesh, one rank process a lane (``QREngine(mesh=)``), bit-equal to the
single-process engine. The trainer spawns the mesh's ranks at its first
sweep and stops them at ``close()`` (or the end of a ``with`` block); a
mesh passed in (``mesh=``, e.g. on a group other work shares) stays open.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import tree
from repro_torch.ckpt import save
from repro_torch.ckpt.sweep import load_sweep_state, save_sweep_state
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.coding import MDSScheme
from repro_torch.ft.driver import obliterate_state
from repro_torch.ft.failures import prev_sweep_point
from repro_torch.ft.online.state import WIRE_VERSION
from repro_torch.ft.semantics import Semantics
import repro_torch.optim.adamw as adamw_mod
from repro_torch.optim import powersgd
from repro_torch.optim.caqr_muon import MuonState, _orth, muon_deltas, muon_moments
from repro_torch.train.loop import TrainConfig, Trainer, restore_tree
from repro_torch.train.step import TrainState, grad_norm, make_loss_and_grads
from repro_torch.train.ftrun.engine import QREngine, SuspendAfter, SuspendSweep
from repro_torch.train.ftrun.tasks import (
    QRTask,
    assemble_leaves,
    leaf_by_path,
    plan_muon_tasks,
    plan_psgd_tasks,
    task_slice,
)


@dataclasses.dataclass
class FTRunConfig:
    """Knobs of the FT factorization layer (the training knobs stay on
    ``TrainConfig``)."""

    qr_lanes: Optional[int] = None    # None: 4, or pow2_lanes() with a mesh
    panel_width: int = 16
    min_qr_size: int = 8192           # per-slice element floor for routing
    use_mesh: bool = False            # points over a lane mesh's ranks
    async_segments: bool = False      # double-buffered segment dispatch
    mds_f: int = 0                    # >0: MDSScheme(f) parity lanes
    compression_rank: int = 0         # >0: PowerSGD bridge (adamw only)
    compression_min_size: int = 8192
    suspend_after_boundaries: int = 0  # >0: suspend mid-sweep (muon only)
    sweep_path: str = ""              # default: <ckpt_dir>/sweep.npz
    sweep_wire_version: int = WIRE_VERSION


class TrainingSuspended(Exception):
    """Raised when a sweep suspension hook fires: the model checkpoint and
    the in-flight sweep state are on disk."""

    def __init__(self, step: int, task: str, sweep_path: str):
        super().__init__(
            f"training suspended at step {step} inside sweep task {task!r}")
        self.step = step
        self.task = task
        self.sweep_path = sweep_path


class StepSweepKiller:
    """Engine fault hook: poison ``lane`` during the optimizer-internal
    sweep of training step ``at_step`` — optionally a specific ``task``
    and/or sweep ``point``; by default the first completed point of the
    step's first sweep. Fires once; records ``(step, task, point)`` in
    ``.struck``. Recovery is the sweep's own REBUILD."""

    def __init__(self, at_step: int, lane: int,
                 task: Optional[str] = None,
                 point: Optional[Tuple[int, str, int]] = None):
        self.at_step = at_step
        self.lane = lane
        self.task = task
        self.point = point
        self.trainer: Optional["FTTrainer"] = None  # bound by FTTrainer
        self.fired = False
        self.struck: Optional[Tuple[int, str, Tuple[int, str, int]]] = None

    def __call__(self, comm, state):
        if self.fired or self.trainer is None:
            return state
        if self.trainer._cur_step != self.at_step:
            return state
        if self.task is not None and self.trainer._cur_task != self.task:
            return state
        pt = prev_sweep_point(state.cursor, state.geom.n_panels,
                              state.geom.levels)
        if pt is None or (self.point is not None and pt != self.point):
            return state
        self.fired = True
        self.struck = (self.trainer._cur_step, self.trainer._cur_task, pt)
        return obliterate_state(comm, state, self.lane)


def _lane_project(G_l, omega, err_l):
    """Per-lane ``psgd_project`` and the lane mean of the projections."""
    Gc_l, P_l = zip(*(powersgd.psgd_project(g, omega, e)
                      for g, e in zip(G_l, err_l)))
    return torch.stack(Gc_l), torch.mean(torch.stack(P_l), dim=0)


def _lane_complete(Gc_l, Q):
    """The lane mean of ``psgd_rfactor``, then per-lane ``psgd_complete``:
    ``(G_hat, per-lane errors, R)``."""
    R = torch.mean(torch.stack([powersgd.psgd_rfactor(gc, Q) for gc in Gc_l]),
                   dim=0)
    G_hat, err_l = zip(*(powersgd.psgd_complete(gc, Q, R, torch.float32)
                         for gc in Gc_l))
    return G_hat[0], torch.stack(err_l), R


class FTTrainer(Trainer):
    """``Trainer`` whose optimizer-internal factorizations run on a
    :class:`QREngine`. Diskless buddy checkpoints, lane-failure semantics
    and deterministic replay are the base loop's."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                 fcfg: Optional[FTRunConfig] = None,
                 qr_fault_hooks: Sequence = (), device="cuda", mesh=None):
        super().__init__(cfg, tcfg, dcfg, device=device)
        self.fcfg = fcfg = fcfg or FTRunConfig()
        lanes = fcfg.qr_lanes
        self._own_mesh = False
        if fcfg.use_mesh:
            if mesh is None:
                from repro_torch.launch.spmd_qr import make_lane_mesh, pow2_lanes

                if lanes is None:
                    lanes = pow2_lanes()
                mesh = make_lane_mesh(lanes, device=self.device)
                self._own_mesh = True
            elif lanes is None:
                (lanes,) = mesh.devices.shape
        else:
            assert mesh is None, "a mesh runs the sweeps only with use_mesh"
            if lanes is None:
                lanes = 4
        self.mesh = mesh
        self._qr_hooks = list(qr_fault_hooks)
        for h in self._qr_hooks:
            if hasattr(h, "trainer"):
                h.trainer = self
        boundary_hooks = []
        if fcfg.suspend_after_boundaries:
            boundary_hooks.append(SuspendAfter(fcfg.suspend_after_boundaries))
        self.engine = QREngine(
            n_lanes=lanes,
            panel_width=fcfg.panel_width,
            mesh=mesh,
            scheme=MDSScheme(fcfg.mds_f) if fcfg.mds_f else None,
            semantics=Semantics.REBUILD,
            async_segments=fcfg.async_segments,
            fault_hooks=self._qr_hooks,
            boundary_hooks=boundary_hooks,
        )
        self._cur_step = -1
        self._cur_task: Optional[str] = None
        self._pending_resume: Optional[Tuple[str, object]] = None
        self.phase_s = {"grad": 0.0, "tasks": 0.0, "finish": 0.0}
        self._mode = "plain"
        if tcfg.optimizer == "caqr_muon":
            self._mode = "muon"
            self._tasks = plan_muon_tasks(self.state.params, fcfg.min_qr_size)
            assert self._tasks, (
                "no Muon leaf reaches min_qr_size; lower it or use the "
                "plain Trainer")
            self._grad_fn = self._make_muon_grad()
            self._finish_fn = self._make_muon_finish()
        elif fcfg.compression_rank > 0:
            assert tcfg.optimizer == "adamw", (
                "the PowerSGD bridge pairs with adamw")
            self._mode = "psgd"
            self._tasks = plan_psgd_tasks(self.state.params,
                                          fcfg.compression_min_size)
            assert self._tasks, "no leaf reaches compression_min_size"
            self._lane_grad_fn = self._make_lane_grads()
            self._psgd_finish_fn = self._make_psgd_finish()
            self._psgd = self._init_psgd()
        if fcfg.suspend_after_boundaries:
            assert self._mode == "muon", (
                "mid-sweep suspension is supported on the caqr_muon routing "
                "(the PowerSGD bridge's host-side error buffers are not in "
                "the model checkpoint)")

    def close(self) -> None:
        """Stop the mesh's ranks if the trainer made the mesh."""
        if self._own_mesh:
            self.mesh.close()

    def __enter__(self) -> "FTTrainer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _clock(self, phase: str, t0: float) -> float:
        self._sync()
        t = time.perf_counter()
        self.phase_s[phase] += t - t0
        return t

    # -- diskless checkpoints carry the bridge's host-side state ------------

    def _diskless_blob(self, step: int):
        blob = super()._diskless_blob(step)
        if self._mode == "psgd":
            blob["psgd"] = self._psgd
        return blob

    def _restore_blob(self, blob) -> None:
        super()._restore_blob(blob)
        if "psgd" in blob:
            self._psgd = restore_tree(blob["psgd"], self._psgd)

    # -- muon phases ---------------------------------------------------------

    def _make_muon_grad(self):
        loss_and_grads = make_loss_and_grads(self.cfg, self.tcfg.grad_accum)
        lr_fn = self._lr_fn

        def grad_phase(state: TrainState, batch):
            loss, grads = loss_and_grads(state.params, batch)
            with torch.no_grad():
                mom, nu = muon_moments(grads, state.opt_state, state.params)
                return (loss, grad_norm(grads), lr_fn(state.step),
                        state.opt_state.step + 1, mom, nu)

        return grad_phase

    def _make_muon_finish(self):
        @torch.no_grad()
        def finish(state: TrainState, mom, nu, lr, ostep, qs):
            def orth(path, m):
                # each Q is used once: dropping it as it is used keeps the
                # finish phase's peak at one leaf's Q above the deltas
                q = qs.pop(path, None)
                return _orth(m) if q is None else q

            updates = muon_deltas(state.params, mom, nu, lr, ostep.float(),
                                  orth=orth)
            params = adamw_mod.apply_updates(state.params, updates)
            return TrainState(params, MuonState(ostep, mom, nu),
                              state.step + 1)

        return finish

    def _muon_step(self, step: int, batch) -> Dict:
        t = time.perf_counter()
        loss, gnorm, lr, ostep, mom, nu = self._grad_fn(self.state, batch)
        t = self._clock("grad", t)
        per_task: Dict[str, torch.Tensor] = {}
        for task in self._tasks:
            self._cur_task = task.name
            resume = None
            if (self._pending_resume is not None
                    and self._pending_resume[0] == task.name):
                resume = self._pending_resume[1]
                self._pending_resume = None
            M = task_slice(mom, task)
            try:
                per_task[task.name] = self.engine.orthonormalize(
                    M, resume_state=resume)
            except SuspendSweep as s:
                self._suspend(step, task, s.state)
        self._cur_task = None
        t = self._clock("tasks", t)
        qs = assemble_leaves(mom, per_task, self._tasks)
        del per_task
        self.state = self._finish_fn(self.state, mom, nu, lr, ostep, qs)
        self._clock("finish", t)
        return {"loss": loss, "lr": lr, "gnorm": gnorm}

    # -- powersgd bridge -----------------------------------------------------

    def _init_psgd(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed + 1)
        r = self.fcfg.compression_rank
        st = {}
        for t in self._tasks:
            st[t.name] = {
                "omega": torch.randn((t.cols, r), generator=gen,
                                     dtype=torch.float32,
                                     device=self.device) / math.sqrt(r),
                "err": torch.zeros((self.tcfg.n_lanes, t.rows, t.cols),
                                   dtype=torch.float32, device=self.device),
            }
        return st

    def _make_lane_grads(self):
        loss_and_grads = make_loss_and_grads(self.cfg, self.tcfg.grad_accum)
        L = self.tcfg.n_lanes

        def fn(state: TrainState, batch):
            per = batch["tokens"].shape[0] // L
            outs = [loss_and_grads(state.params,
                                   {k: v[i * per:(i + 1) * per]
                                    for k, v in batch.items()})
                    for i in range(L)]
            loss_l = torch.stack([o[0] for o in outs])
            grads_l = tree.map(lambda *gs: torch.stack(gs), *(o[1] for o in outs))
            return torch.mean(loss_l), grads_l

        return fn

    def _make_psgd_finish(self):
        opt, lr_fn = self.opt, self._lr_fn

        @torch.no_grad()
        def finish(state: TrainState, grads):
            lr = lr_fn(state.step)
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params, lr)
            params = adamw_mod.apply_updates(state.params, updates)
            return TrainState(params, opt_state, state.step + 1), lr

        return finish

    def _psgd_step(self, step: int, batch) -> Dict:
        L = self.tcfg.n_lanes
        t = time.perf_counter()
        loss, grads_l = self._lane_grad_fn(self.state, batch)
        t = self._clock("grad", t)
        per_task: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for task in self._tasks:
                self._cur_task = task.name
                st = self._psgd[task.name]
                leaf_l = leaf_by_path(grads_l, task.path)
                flat = leaf_l.reshape((L, -1) + tuple(leaf_l.shape[-2:]))
                G_l = flat[:, task.index if task.index is not None else 0]
                Gc_l, proj = _lane_project(G_l, st["omega"], st["err"])
                Q = self.engine.orthonormalize(proj)
                G_hat, new_err, R = _lane_complete(Gc_l, Q)
                st["omega"], st["err"] = R, new_err  # power-iteration warm start
                per_task[task.name] = G_hat
            self._cur_task = None
            t = self._clock("tasks", t)
            mean_grads = tree.map(lambda g: torch.mean(g, dim=0), grads_l)
            comp = assemble_leaves(mean_grads, per_task, self._tasks)
            reduced = tree.map_with_path(lambda path, g: comp.get(path, g),
                                         mean_grads)
            self.state, lr = self._psgd_finish_fn(self.state, reduced)
            gnorm = grad_norm(reduced)
        self._clock("finish", t)
        return {"loss": loss, "lr": lr, "gnorm": gnorm}

    # -- step dispatch -------------------------------------------------------

    def _execute_step(self, step: int, batch) -> Dict:
        self._cur_step = step
        if self._mode == "muon":
            return self._muon_step(step, batch)
        if self._mode == "psgd":
            return self._psgd_step(step, batch)
        return super()._execute_step(step, batch)

    # -- suspend / resume ----------------------------------------------------

    def _sweep_path(self) -> str:
        return self.fcfg.sweep_path or os.path.join(
            self.tcfg.ckpt_dir, "sweep.npz")

    def _suspend(self, step: int, task: QRTask, sweep_state) -> None:
        os.makedirs(self.tcfg.ckpt_dir, exist_ok=True)
        save.save(self.tcfg.ckpt_dir, step, self.state.params,
                  self.state.opt_state,
                  {"data_step": step, "ftrun_task": task.name})
        path = self._sweep_path()
        save_sweep_state(path, sweep_state,
                         version=self.fcfg.sweep_wire_version)
        raise TrainingSuspended(step, task.name, path)

    @classmethod
    def resume(cls, cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
               fcfg: Optional[FTRunConfig] = None,
               qr_fault_hooks: Sequence = (), device="cuda",
               mesh=None) -> "FTTrainer":
        """Rebuild a trainer from a suspended run's checkpoints (either
        package's): params/opt state as of entering the suspended step, the
        persisted in-flight sweep queued for ``from_state`` continuation,
        and the loop set to replay from that step. Pass a ``fcfg`` without
        ``suspend_after_boundaries`` unless another suspension is wanted."""
        tr = cls(cfg, tcfg, dcfg, fcfg, qr_fault_hooks, device=device,
                 mesh=mesh)
        params, opt_state, manifest = save.restore(
            tcfg.ckpt_dir, tr.state.params, tr.state.opt_state)
        step = int(manifest["step"])
        tr.state = TrainState(params, opt_state,
                              torch.tensor(step, dtype=torch.int32))
        tr._start_step = step
        task = (manifest.get("extra") or {}).get("ftrun_task")
        if task is not None:
            tr._pending_resume = (task, load_sweep_state(tr._sweep_path(),
                                                         device=tr.device))
        return tr
