"""Training loop with the fault-tolerance supervisor (port of
``src/repro/train/loop.py``).

The loop drives logical data-parallel lanes through deterministic data,
takes diskless (buddy) checkpoints of the full training state every
``diskless_every`` steps plus periodic disk checkpoints, and reacts to
detected lane failures with the configured semantics:

  REBUILD — restore params+opt from the buddy store, rewind the data
            pipeline to the checkpointed step and replay: training
            continues bit-identical to a failure-free run.
  SHRINK  — drop the lane: the global batch loses its rows.
  BLANK   — keep the hole: the dead lane's rows are masked out.
  ABORT   — re-raise.

The trainer's tensors live on ``device`` (the card by default; it raises
without one unless given ``device="cpu"``). Bit-identical replay on the
card needs deterministic kernels: run under
``torch.use_deterministic_algorithms(True)`` with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (``launch/train.py`` and
``chip_smoke.py`` set both).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.ckpt import diskless, save
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.ft.failures import Detector, FailureSchedule
from repro_torch.ft.semantics import Semantics
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import transformer as tf
import repro_torch.optim.adamw as adamw_mod
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train.step import TrainState, make_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    lr: float = 3e-3
    warmup: int = 10
    grad_accum: int = 1
    n_lanes: int = 4                  # logical data-parallel lanes
    diskless_every: int = 5
    ckpt_every: int = 0               # 0 = no disk checkpoints
    ckpt_dir: str = "/tmp/repro_ckpt"
    semantics: Semantics = Semantics.REBUILD
    optimizer: str = "adamw"          # adamw | caqr_muon
    log_every: int = 10
    seed: int = 0


def restore_tree(host_tree, like):
    """A host (numpy) snapshot back into tensors with ``like``'s dtypes and
    devices."""
    return save.fill(like, dict(tree.flatten_with_path(host_tree)))


class Trainer:
    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, dcfg: DataConfig,
                 device="cuda"):
        self.cfg, self.tcfg, self.dcfg = cfg, tcfg, dcfg
        self.device = resolve_device(device)
        assert dcfg.global_batch % tcfg.n_lanes == 0
        if tcfg.optimizer == "caqr_muon":
            from repro_torch.optim.caqr_muon import caqr_muon

            self.opt = caqr_muon()
        else:
            self.opt = adamw_mod.adamw()
        self._lr_fn = warmup_cosine(tcfg.lr, tcfg.warmup, tcfg.steps)
        self._step_fn = make_train_step(cfg, self.opt, self._lr_fn, tcfg.grad_accum)
        gen = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        params = tf.init_params(cfg, gen)
        self.state = TrainState(params, self.opt.init(params),
                                torch.zeros((), dtype=torch.int32))
        self.buddy = diskless.BuddyStore(max(tcfg.n_lanes, 2))
        self.detector = Detector(tcfg.n_lanes)
        self.active_lanes: List[int] = list(range(tcfg.n_lanes))
        self.blanked: List[int] = []
        self._last_diskless_step = -1
        self._start_step = 0          # nonzero when resuming a suspended run
        self.history: List[Dict] = []

    # -- diskless checkpoint of the full training state ---------------------
    def _diskless_blob(self, step: int) -> Dict[str, Any]:
        return {"state": self.state, "step": step}

    def _push_diskless(self, step: int) -> None:
        # one host snapshot, replicated into every live lane's buddy store
        blob = diskless._to_host(self._diskless_blob(step))
        for lane in self.active_lanes:
            self.buddy.push(lane, blob)
        self._last_diskless_step = step

    def _restore_blob(self, blob: Dict[str, Any]) -> None:
        self.state = restore_tree(blob["state"], self.state)

    def _restore_diskless(self, failed: int) -> int:
        blob = self.buddy.recover(failed)
        self._restore_blob(blob)
        return int(blob["step"])

    # -- failure handling ----------------------------------------------------
    def _handle_failures(self, step: int, lanes: List[int]) -> int:
        """Returns the (possibly rewound) step to continue from."""
        sem = self.tcfg.semantics
        if sem == Semantics.ABORT:
            raise RuntimeError(f"lanes {lanes} failed at step {step}; ABORT")
        if sem == Semantics.REBUILD:
            resume = step
            for lane in lanes:
                ck_step = self._restore_diskless(lane)
                resume = min(resume, ck_step)
                self.detector.revive(lane)
            return resume  # deterministic data replay from the ckpt step
        if sem == Semantics.SHRINK:
            for lane in lanes:
                self.active_lanes.remove(lane)
            assert self.active_lanes, "all lanes dead"
            return step
        if sem == Semantics.BLANK:
            self.blanked.extend(lanes)
            return step
        raise ValueError(sem)

    def _lane_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The global batch from the rows of live lanes, on the device."""
        per = self.dcfg.global_batch // self.tcfg.n_lanes
        full = make_batch(self.dcfg, step)
        rows = []
        for lane in range(self.tcfg.n_lanes):
            if lane in self.blanked or lane not in self.active_lanes:
                continue
            rows.append(slice(lane * per, (lane + 1) * per))
        sel = np.concatenate([np.r_[r] for r in rows])
        return {k: torch.from_numpy(v[sel]).to(self.device) for k, v in full.items()}

    # -- step execution (overridden by the FT runtime) ----------------------
    def _execute_step(self, step: int, batch) -> Dict[str, Any]:
        """One optimizer step: advance ``self.state``, return metrics."""
        self.state, metrics = self._step_fn(self.state, batch)
        return metrics

    # -- main loop -------------------------------------------------------------
    def run(self, schedule: Optional[FailureSchedule] = None) -> List[Dict]:
        self.detector.schedule = schedule or FailureSchedule()
        step = self._start_step
        while step < self.tcfg.steps:
            newly_dead = self.detector.begin_step(step)
            if newly_dead:
                step = self._handle_failures(step, newly_dead)
            if step % self.tcfg.diskless_every == 0:
                self._push_diskless(step)
            if self.tcfg.ckpt_every and step and step % self.tcfg.ckpt_every == 0:
                save.save_async(
                    self.tcfg.ckpt_dir, step, self.state.params,
                    self.state.opt_state, {"data_step": step})
            batch = self._lane_batch(step)
            t0 = time.perf_counter()
            metrics = self._execute_step(step, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            rec = {
                "step": step,
                "loss": loss,
                "lanes": len(self.active_lanes) - len(self.blanked),
                "dt": dt,
            }
            self.history.append(rec)
            if step % self.tcfg.log_every == 0:
                print(f"step {step:5d} loss {rec['loss']:.4f} "
                      f"lanes {rec['lanes']} {dt*1e3:.1f}ms")
            step += 1
        return self.history
