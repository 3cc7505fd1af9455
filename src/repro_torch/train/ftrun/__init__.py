"""Fault-tolerant training runtime of the port (counterpart of
``src/repro/train/ftrun/``): the optimizer's own factorizations run as
online FT-CAQR sweeps (K1-K4 on the card), healed in place when lanes die
mid-step, suspendable and resumable, with optional async double-buffered
segments."""
from repro_torch.train.ftrun.engine import QREngine, SuspendAfter, SuspendSweep
from repro_torch.train.ftrun.runtime import (
    FTRunConfig,
    FTTrainer,
    StepSweepKiller,
    TrainingSuspended,
)
from repro_torch.train.ftrun.tasks import (
    QRTask,
    plan_muon_tasks,
    plan_psgd_tasks,
)

__all__ = [
    "QREngine", "SuspendAfter", "SuspendSweep", "FTRunConfig", "FTTrainer",
    "StepSweepKiller", "TrainingSuspended", "QRTask", "plan_muon_tasks",
    "plan_psgd_tasks",
]
