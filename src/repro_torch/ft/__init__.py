"""Fault tolerance of the port (counterpart of ``src/repro/ft/``): failure
injection and the sweep-point cursor algebra (``failures``), the semantics
enum, the XOR coding seam (``coding``), the sweep state machine
(``online.state``) and the scheduled REBUILD driver (``driver``). Only
what is ported is exported; elastic, stragglers, the MDS scheme and the
online orchestrator are not ported yet.
"""
from repro_torch.ft import coding, failures, semantics
from repro_torch.ft.coding import CodingScheme, XORPairScheme
from repro_torch.ft.failures import (
    Detector,
    FailureSchedule,
    LaneFailure,
    UnrecoverableFailure,
    iter_sweep_points,
    next_sweep_point,
    prev_sweep_point,
    sweep_point,
)
from repro_torch.ft.semantics import Semantics
from repro_torch.ft import online
from repro_torch.ft.online.state import SweepState, initial_sweep_state, sweep_step
from repro_torch.ft import driver
from repro_torch.ft.driver import (
    FTSweepDriver,
    FTSweepResult,
    RecoveryEvent,
    ft_caqr_sweep,
    obliterate_state,
    rebuild_state,
    recover_lanes,
)

__all__ = [
    "coding", "driver", "failures", "online", "semantics",
    "Semantics", "CodingScheme", "XORPairScheme",
    "FTSweepDriver", "FTSweepResult", "RecoveryEvent", "ft_caqr_sweep",
    "obliterate_state", "rebuild_state", "recover_lanes",
    "Detector", "FailureSchedule", "LaneFailure", "UnrecoverableFailure",
    "iter_sweep_points", "next_sweep_point", "prev_sweep_point",
    "sweep_point",
    "SweepState", "initial_sweep_state", "sweep_step",
]
