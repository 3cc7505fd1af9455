"""Checkpoints of the port (counterpart of ``src/repro/ckpt/``): training
checkpoints on disk (``save``), suspend and restore of in-flight FT-CAQR
sweeps (``sweep``) and the diskless buddy, parity and sweep-state stores
(``diskless``)."""
from repro_torch.ckpt import diskless, save, sweep
from repro_torch.ckpt.sweep import load_sweep_state, save_sweep_state

__all__ = ["diskless", "save", "sweep", "load_sweep_state", "save_sweep_state"]
