"""Fault tolerance of the port (counterpart of ``src/repro/ft/``): failure
injection and the sweep-point cursor algebra (``failures``), the semantics
enum, the coding seam with the XOR pairing and the GF(2^8) MDS scheme
(``coding``), the scheduled REBUILD driver (``driver``), the SHRINK/BLANK
continuation (``elastic``), straggler policies (``stragglers``), and the
online subsystem (``online``: the state machine, runtime detection and the
host orchestrator).
"""
from repro_torch.ft import coding, failures, semantics, stragglers
from repro_torch.ft.coding import CodingScheme, MDSScheme, XORPairScheme
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
from repro_torch.ft.stragglers import (
    SpeculationEvent,
    StragglerConfig,
    StragglerMonitor,
    StragglerPolicy,
)
from repro_torch.ft import online
from repro_torch.ft.online.state import SweepState, initial_sweep_state, sweep_step
from repro_torch.ft import driver, elastic
from repro_torch.ft.driver import (
    FTSweepDriver,
    FTSweepResult,
    RecoveryEvent,
    ft_caqr_sweep,
    obliterate_state,
    rebuild_state,
    recover_lanes,
)
from repro_torch.ft.elastic import (
    ElasticController,
    ElasticSweepResult,
    LaneWorld,
    TransitionEvent,
    ft_caqr_sweep_elastic,
)
# the online subsystem reuses the driver's REBUILD transitions, so its
# sibling modules load after the driver (online/__init__ is state-only)
from repro_torch.ft.online import detect, orchestrator  # noqa: F401
from repro_torch.ft.online.detect import (
    DelayedDetector,
    FailStopDetector,
    NaNSentinelDetector,
    ScriptedKiller,
    WallClockKiller,
)
from repro_torch.ft.online.orchestrator import (
    SweepOrchestrator,
    compiled_segment,
    ft_caqr_sweep_online,
)

__all__ = [
    "coding", "driver", "elastic", "failures", "online", "semantics",
    "stragglers",
    "Semantics", "CodingScheme", "MDSScheme", "XORPairScheme",
    "FTSweepDriver", "FTSweepResult", "RecoveryEvent", "ft_caqr_sweep",
    "obliterate_state", "rebuild_state", "recover_lanes",
    "Detector", "FailureSchedule", "LaneFailure", "UnrecoverableFailure",
    "iter_sweep_points", "next_sweep_point", "prev_sweep_point",
    "sweep_point",
    "SweepState", "initial_sweep_state", "sweep_step",
    "ElasticController", "ElasticSweepResult", "LaneWorld",
    "TransitionEvent", "ft_caqr_sweep_elastic",
    "SpeculationEvent", "StragglerConfig", "StragglerMonitor",
    "StragglerPolicy",
    "DelayedDetector", "FailStopDetector", "NaNSentinelDetector",
    "ScriptedKiller", "WallClockKiller",
    "SweepOrchestrator", "compiled_segment", "ft_caqr_sweep_online",
]
