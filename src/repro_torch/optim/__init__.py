"""Optimizers of the port (counterpart of ``src/repro/optim/``): AdamW,
CAQR-Muon (momentum orthogonalized by the port's TSQR), PowerSGD-QR
gradient compression and the LR schedules. ``adafactor`` (used only by
the JAX package's dry-run) waits (``ROADMAP.md`` queue 1).

Import the factory functions from their modules
(``repro_torch.optim.adamw.adamw``)."""
from repro_torch.optim import adamw, caqr_muon, powersgd, schedule

__all__ = ["adamw", "caqr_muon", "powersgd", "schedule"]
