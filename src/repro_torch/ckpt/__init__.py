"""Checkpoints of the port (counterpart of ``src/repro/ckpt/``): suspend and
restore of in-flight FT-CAQR sweeps (``sweep``) and the diskless buddy,
parity and sweep-state stores (``diskless``). The training checkpoints of
``repro/ckpt/save.py`` wait for the training port."""
from repro_torch.ckpt import diskless, sweep
from repro_torch.ckpt.sweep import load_sweep_state, save_sweep_state

__all__ = ["diskless", "sweep", "load_sweep_state", "save_sweep_state"]
