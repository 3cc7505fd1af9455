"""Core FT-CAQR library of the port (counterpart of ``src/repro/core/``).

Layers: householder (WY substrate), tsqr (FT butterfly), trailing
(Algorithms 1 and 2), caqr (the windowed sweep), lstsq, recovery
(single-source REBUILD) and comm (the P-lane layout).
"""
from repro_torch.core.comm import SimComm
from repro_torch.core.householder import (
    WY,
    StackedQR,
    apply_q,
    apply_qt,
    build_t,
    householder_qr,
    householder_qr_masked,
    panel_qr_apply,
    q_dense,
    stacked_apply_q,
    stacked_apply_qt,
    stacked_qr,
)
from repro_torch.core.tsqr import (
    ChainFactors,
    DistTSQRFactors,
    baseline_tsqr,
    dist_orthonormalize,
    ft_tsqr,
    ft_tsqr_level,
    ft_tsqr_q,
    local_tsqr,
    local_tsqr_q,
    tsqr_orthonormalize,
)
from repro_torch.core.trailing import (
    RecoveryBundle,
    TrailingLevelStep,
    trailing_combine_level,
    trailing_update_baseline,
    trailing_update_ft,
)
from repro_torch.core.caqr import (
    CAQRResult,
    PanelFactors,
    SweepGeometry,
    assemble_R,
    block_row_layout,
    caqr_apply_qt,
    caqr_apply_qt_batched,
    caqr_factorize,
    caqr_factorize_batched,
    lane_geometry,
    pad_to_geometry,
    panel_geometry,
    sweep_geometry,
)
from repro_torch.core import lstsq, recovery
