"""Optimizers of the port (counterpart of ``src/repro/optim/``): AdamW,
Adafactor (factored second moments, the dry run's choice for its largest
cells), CAQR-Muon (momentum orthogonalized by the port's TSQR),
PowerSGD-QR gradient compression and the LR schedules.

Import the factory functions from their modules
(``repro_torch.optim.adamw.adamw``)."""
from repro_torch.optim import adafactor, adamw, caqr_muon, powersgd, schedule

__all__ = ["adafactor", "adamw", "caqr_muon", "powersgd", "schedule"]
