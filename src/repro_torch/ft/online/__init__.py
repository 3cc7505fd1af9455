"""Online recovery of the port (counterpart of ``src/repro/ft/online/``).

``state``        the reified sweep state machine (``SweepState``,
                 ``sweep_step``, ``run_panel_fused``) and its host wire
                 format;
``detect``       runtime failure detectors (the NaN-sentinel probe and the
                 injectable fail-stop doubles) and fault injectors;
``orchestrator`` the host loop: sweep segments, detector polls between
                 them, REBUILD for whatever the detector found, persistence
                 hooks.

Only ``state`` is imported here: ``repro_torch.ft.driver`` is a loop over
``state.sweep_step`` while ``detect`` and ``orchestrator`` use the
driver's obliterate/REBUILD transitions, so ``repro_torch.ft.__init__``
imports those two after the driver (the import graph stays acyclic).
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
    "detect", "orchestrator", "state",
    "SweepState", "WIRE_VERSION", "deposit_boundary", "finalize",
    "initial_sweep_state", "panel_points", "run_panel_fused", "run_steps",
    "state_lane_axes", "sweep_state_from_host", "sweep_state_to_host",
    "sweep_step",
]
