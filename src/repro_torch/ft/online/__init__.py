"""Online recovery of the port (counterpart of ``src/repro/ft/online/``):
so far only ``state``, the reified sweep state machine (``SweepState``,
``sweep_step``, ``run_panel_fused``) and its host wire format. The runtime
detectors and the orchestrator are not ported yet.
"""
from repro_torch.ft.online import state
from repro_torch.ft.online.state import (
    SweepState,
    WIRE_VERSION,
    deposit_boundary,
    finalize,
    initial_sweep_state,
    panel_points,
    run_panel_fused,
    run_steps,
    state_lane_axes,
    sweep_state_from_host,
    sweep_state_to_host,
    sweep_step,
)

__all__ = [
    "state",
    "SweepState", "WIRE_VERSION", "deposit_boundary", "finalize",
    "initial_sweep_state", "panel_points", "run_panel_fused", "run_steps",
    "state_lane_axes", "sweep_state_from_host", "sweep_state_to_host",
    "sweep_step",
]
