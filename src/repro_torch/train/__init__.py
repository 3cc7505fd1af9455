"""Training of the port (counterpart of ``src/repro/train/``): the step
builders, the FT-supervised loop, and the FT training runtime whose
optimizer factorizations run as online FT-CAQR sweeps (``ftrun``)."""
from repro_torch.train.loop import TrainConfig, Trainer
from repro_torch.train.step import (
    PodTrainState,
    TrainState,
    grad_norm,
    make_loss_and_grads,
    make_pod_train_step,
    make_train_step,
)

__all__ = [
    "PodTrainState", "TrainConfig", "Trainer", "TrainState", "grad_norm",
    "make_loss_and_grads", "make_pod_train_step", "make_train_step",
]
