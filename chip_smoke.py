"""Drive the PyTorch/CUDA port of FT-CAQR on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on a failed check (the script then exits
non-zero and prints no result):

1. report and build: the card's name and power limit; every CUDA kernel
   built from ``src/repro_torch/csrc`` (one nvcc per source, in parallel).
2. kernels: K1-K6 at the sweep's first-panel shapes against their plain
   PyTorch versions, timed with CUDA events beside the plain version and
   one PyTorch call computing the same function (K1-K4) or the stepped
   kernels doing the same work (K5: K1+K2; K6: the stepped panel); the
   check that one lane of a P-lane launch equals a launch of it alone
   (K1-K5), and that K3 gives the two lanes of a butterfly pair, which
   stack the same two R factors, equal bits; every kernel's device time
   (torch.profiler); K3's and K6's shared memory a block, and K6's blocks
   per SM; K2 and K4 also at a late panel (w = 512) and on one lane (the
   REBUILD replay), bit-equal at two column tiles, and K1 on one lane (the
   REBUILD replay) and at the last panel's row start (rs = 3968) beside
   ``torch.geqrf`` on the same rows, all timed on the device alone
   (torch.profiler) beside the events' time, which for a short kernel
   includes the host's time to issue it; each kernel's registers and
   spills from its build log; one JSON line per kernel, and one with K1's
   team (its size, shared memory, and how many teams the card holds at
   once, from cudaOccupancyMaxActiveClusters).
3. sweep: the windowed FT-CAQR sweep of a 32768 x 4096 f32 matrix over
   P = 8 lanes at panel width 128 (32 panels, 3 butterfly levels), with
   the launch counters at 0 before it; checks that K1-K4 ran, that R is
   replicated bitwise, the Gram identity, Q^T A = [R; 0] and a
   least-squares solve. Then device time by kernel over one more sweep,
   from torch.profiler.
4. fused leaf: ``householder.panel_qr_apply`` (K5) on the first panel's
   window, counters at 0 before it, bit-equal to the stepped leaf.
5. state machine + fused: the same matrix through ``run_steps`` and,
   separately, ``run_panel_fused`` over all 32 panels (K6, counters at 0
   before it; no K1-K4 launch inside), each with ``finalize``: seconds,
   launches, peak memory; both bit-equal to the sweep's R, factors and
   bundles, and to each other at every panel boundary.
6. FT driver: ``ft_caqr_sweep`` on the same matrix with four kills (an
   early leaf point, a tsqr point and a trailing point of the panel's
   root lane mid-sweep, the last panel's last trailing point), R, factors
   and bundles bit-equal to the failure-free sweep, one single-source
   event per kill, each REBUILD's seconds; and with the same lanes killed
   at the ends of those panels (the fused path's boundaries).
7. online: ``ft_caqr_sweep_online`` on the same matrix, stepped and fused
   without a death, stepped with the four kills (a ``ScriptedKiller``,
   found by the NaN sentinel), fused with the panel-end kills, and
   stepped with double-buffered segments: R, factors and bundles
   bit-equal to the failure-free (and so to the scheduled) sweep, the
   event ledgers equal to the scheduled runs'; seconds, segments,
   boundaries, poll and recovery seconds, peak memory and launches. Then
   fused under ``MDSScheme(f=2)`` with two simultaneous non-buddy deaths
   at one boundary, decoded jointly and bit-equal to failure-free, with
   the refresh seconds per boundary and the parity's bytes.
8. spmd: one process per lane. Eight ranks spawned once
   (``repro_torch.launch.spmd_qr.make_lane_group``, start method spawn)
   in a gloo group, all on the one card, after the kernels are built here
   (the ranks load the built libraries and start no nvcc); every
   collective goes through pinned host buffers. On the tall matrix:
   ``caqr_factorize_spmd`` at b = 128 (R bit-equal to the sweep phase's,
   the Gram identity), ``caqr_lstsq`` over ``AxisComm`` (within 1e-3 of
   float64), ``ft_caqr_sweep_spmd`` with the FT driver's four kills (R,
   factors and bundles bit-equal to the failure-free sweep, the ledger
   equal to that phase's), the ``MDSScheme(f=2)`` parity after panel 0
   (bytes equal to the single-process encode, and the seconds of one
   refresh across the ranks), and ``caqr_factorize_spmd`` at b = 256
   (R bit-equal to the single-process b = 256 sweep: each rank's K1 is
   the one cooperative launch of ``csrc/panel_qr_wide.cu``). The
   ``MDSScheme(f=2)`` run with two simultaneous non-buddy deaths at one
   point runs on a 4096 x 512 matrix (``SPMD_MDS``), not on the tall one:
   bit-equal to failure-free, the ledger and the parity bytes equal to a
   single-process run's. The scheduled tall joint decode across ranks is
   not run: the scheduled driver re-encodes every protected leaf at each
   of its points across the ranks (the online run below decodes the tall
   matrix instead, encoding on the parent). Prints each run's seconds and
   each rank's K1-K6 launches (K1-K4 must be above 0 on every rank),
   seconds, collectives
   and the bytes it staged between the card and host memory and sent
   through gloo. Then the online and elastic paths over the same ranks
   (``ft_caqr_sweep_online_spmd``, ``ft_caqr_sweep_elastic_spmd``: the
   host orchestrator here holds the global state, each rank runs one
   ``sweep_step`` a point and gets only the leaves that changed): failure-
   free and with the four kills (bit-equal to the failure-free sweep, the
   scheduled ledger); ``MDSScheme(f=2)`` on the tall matrix with two
   simultaneous non-buddy deaths, a panel a segment (one refresh a panel
   on the parent's global state), bit-equal to failure-free and to the
   single-process online run with the same hooks and segments, a joint
   decode; SHRINK with one kill, fold 8 -> 4 onto a subgroup of the first
   four ranks (R bit-equal to the single-process online SHRINK under the
   fold policy, its transitions and ledger, and within the f32 tolerance
   of the failure-free R up to row signs). Each records its seconds,
   segments, boundaries, points, the parent's seconds a point outside the
   ranks, the runner's leaves and bytes shipped and joined, and each
   rank's report. Once the group is closed, no rank process may be left;
   three single-process sweeps (``SPMD_RESIDUE``) are timed
   SPREAD_RUNS times each just before the ranks are spawned and again
   after, so the record shows whether the phase left the single process
   slower.
9. shrink: SHRINK after one death, scheduled (stepped) and online (fused):
   R bit-equal between the two, the Gram identity, the new world (8 slots,
   7 live, the adopter's slice doubled to 8192 rows), and K1 and K6 at
   that height against their plain versions.
10. recovery: the FT trailing update of one panel with lane 3 killed after
   level 1 and rebuilt from one buddy, bitwise equal to the clean run.
11. square: a 4096 x 4096 sweep (m_loc = 512, so the tree root walks lanes
   0-7 and lanes are consumed): fused == stepped at every panel boundary,
   both equal to ``caqr_factorize``, and a kill of a root lane recovered
   bitwise.
12. ragged: an unaligned 32000 x 4000 sweep checked by the Gram identity,
   and fused == stepped at every panel boundary.
13. serve: the QR service (``repro_torch.serve.QRService``) at P = 8,
   b = 128, buckets (m_loc, n) = (1024, 1024) and (4096, 2048), 8 slots:
   24 ragged requests from ``--seed`` (half drawn for each bucket, m in
   [b, P m_loc], n in [b, n - 2], a quarter of the tall ones least
   squares with 2 rhs columns), one submitted a tick. Three runs of that
   traffic: failure-free, lane 2 killed at tick 2 (healed mid-batch by
   the single-source REBUILD), and ``drain_batched`` in groups of four
   requests. Checks: every R meets the Gram identity against its own A,
   every lstsq x is within 1e-3 of the float64 solution (on the card),
   kill == failure-free and drain_batched == continuous bit for bit, every
   tenant resident at the kill healed by one single-source event, K1-K4
   launched on each run, and K1-K4 at each bucket's shapes against their
   plain versions (on a served tenant zero-padded into the bucket and on
   random data: K1 at row start 0 and at the last panel's, on 8 lanes and
   one; K2 at the first, a middle and the last window and on one lane; K3;
   K4 at the first and the last window). Prints requests per second, p50
   and p99 latency, ticks and the median tick, heal seconds per tenant,
   peak memory, and, over a second failure-free drain under torch.profiler
   and against that drain's own wall time, the card's compute share (K1-K4
   and the other kernels) apart from its copy share (Memcpy and Memset).
14. train: the FT training runtime (``repro_torch.train.ftrun``) at
   TinyLlama-1.1B's published width (d_model 2048, 32 heads, 4 kv heads,
   head_dim 64, d_ff 5632, vocab 32000, swiglu, bf16 params), cut to 2
   layers, sequence 1024, global batch 8 over 4 data lanes, 4 steps
   (``TRAIN_REDUCED``), random weights from ``--seed``: ``caqr_muon``
   through ``FTTrainer`` with ``FTRunConfig(qr_lanes=4, panel_width=128)``,
   so 14 full-width online FT-CAQR sweeps a step on K1-K4, under
   ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
   set before CUDA starts). Runs: failure-free twice (bit-equal: the
   determinism check); lane 1 killed at a mid-sweep point of step 2's
   first ``w_in`` sweep (bit-equal params and losses, one single-source
   REBUILD event, no rewind); async double-buffered segments with the same
   kill; suspended to disk inside step 2 and resumed with
   ``FTTrainer.resume``; a training-level lane death at step 3 (diskless
   restore, replay); the PowerSGD bridge (``adamw``, rank 4) for 2 steps,
   failure-free and with a kill in its first sweep; the plain
   ``Trainer(adamw)``. Every run bit-equal to its failure-free run. Checks
   besides: finite losses that fall, every sweep's R of the failure-free
   run against the Gram identity of its momentum slice, K1-K4 launched and
   K5/K6 not on the ``train``, ``train_kill`` and ``train_psgd`` paths, and
   K1-K4 at the path's shapes (``TRAIN_SHAPES``) against their plain
   versions on 4 lanes and one. Prints each run's step seconds, the split
   into grad phase, task loop (engine seconds, polls, sweeps, boundaries,
   segments) and finish phase, heal seconds and peak memory, and device
   time by kernel over one more step under torch.profiler.
15. train_moe: the FT training runtime on mixtral-8x22b at its published
   width (d_model 6144, 48 heads, 8 kv heads, head_dim 128, 8 experts top-2,
   d_ff_expert 16384, vocab 32768, window 4096, rope theta 1e6, bf16
   params), cut to 1 layer, sequence 1024, global batch 8 over 4 data
   lanes, 3 steps (``MOE_REDUCED``), random weights from ``--seed``:
   ``caqr_muon`` through ``FTTrainer`` with ``FTRunConfig(qr_lanes=4,
   panel_width=128)``, so 29 full-width online FT-CAQR sweeps a step on
   K1-K4 (24 expert slices of 16384 x 6144, wq and wo 6144 x 6144, wk and
   wv 6144 x 1024, the router 6144 x 8), under torch's deterministic mode.
   Runs: failure-free twice (params bit-equal, optimizer states with equal
   digests, equal losses); lane 1 killed at a mid-sweep point of step 2
   inside the fourth w_gate expert's sweep (the same bits, one
   single-source REBUILD event, no rewind). Checks: finite losses, every
   sweep's R of the first run against the Gram identity of its momentum
   slice, K1-K4 launched and K5/K6 not on the ``train_moe`` and
   ``train_moe_kill`` paths, and K1-K4 at the path's shapes
   (``MOE_SHAPES``) against their plain versions on 4 lanes and one (on
   random data and on a momentum slice; the router's has rank 7, since
   softmax's logit gradients sum to zero over the experts, so there K1's
   and K3's outputs are held where the first 7 reflectors fix them). Prints
   each run's step seconds and their split, the engine's sweeps,
   boundaries, poll and heal seconds, peak memory, the share of token
   assignments dropped at capacity, and the column norms of the router
   sweep's Q.
16. wide: K1-K4 above 128 columns: K1 (and K3, K1's route on the stacked
   triangles) in one cooperative launch (``csrc/panel_qr_wide.cu``: K1's
   team on sub-panels of 128 columns, on clusters or, for 8 lanes of 4096
   rows, a plain grid; the products between them and in the T join as
   tile phases), K2 and K4
   through the products of ``csrc/wide.cu``. Against their plain versions,
   timed (events, device time, bound, plain, ``torch.geqrf`` or the
   ``torch.matmul`` chain), and K1's and K3's one launch bit-equal to the
   composed route (the same blocked route as separate launches of K1's
   team kernel and ``wide_gemm``, ``panel_qr.panel_qr_composed``) and timed
   beside it (events and device time), with the launch's cluster size and
   grid: K1 on (8, 4096, 256) at
   row start 0 and at the last b = 256 panel's, at the plain CAQR-Muon
   path's shapes (2048, 2048), (5632, 2048), (512, 256) and (768, 256), and
   on a ragged (1000, 200) at row start 37; K2 on Y (8, 4096, 256) and C
   (8, 4096, 4096) with Y's T and with a random upper-triangular T; K3 on
   two (8, 256, 256) R factors; K4 with C' (8, 256, 4096) and a random T;
   the products' kernel alone. Every product inside those records' first
   calls is held bit for bit to the oracle of its summation order
   (``wide.gemm_order``) and to K5/K6's in-block instantiation of the same
   tile routine (``fused_sweep.gemm_in_block``). Bitwise at b = 256: one
   lane == eight lanes (K1, K2, K4), the two lanes of a butterfly pair
   (K3), two column tiles (K2, K4), K5 == K1 then K2. K5 and K6 at b = 256
   on the first window (one cooperative launch each), against their plain
   versions, timed beside their bound and the stepped wide route. The
   sweep of the tall matrix at b = 256 (16 panels, counters at 0 before
   it; path ``wide``): R replicated bitwise, the Gram identity, Q^T A =
   [R; 0], least squares, K1-K4 launched and K5/K6 not; ``ft_caqr_sweep``
   with two kills (a leaf point and a trailing point of the root lane;
   path ``wide_kill``), bit-equal to failure-free, one single-source event
   a kill; ``run_panel_fused`` over the 16 panels (path ``wide_fused``, K6
   only), bit-equal to failure-free and to the stepped state machine at
   every panel boundary; the online sweep with fused segments and the same
   lanes killed at those panels' ends (path ``wide_online_fused``),
   bit-equal to failure-free and to the stepped online sweep, with the
   scheduled run's ledger; five runs of ``caqr_factorize``, the two-kill
   FT sweep and the fused state machine (median, min-max). Then the plain
   ``Trainer(caqr_muon)`` at
   ``TRAIN_REDUCED`` for 3 steps, twice, under torch's deterministic mode
   (path ``muon``): params and losses bit-equal, finite losses, every
   full-rank momentum slice's Q orthonormal within 1e-3 at step 0, K1 at
   the path's shapes on momentum slices against its plain version (within
   the tolerance on the leading columns whose condition number is at most
   1 / DEPENDENT_PIVOT) and against the float64 plain version (no worse
   than four times the f32 plain version, on the columns ``leading_rank``
   keeps), K1 launched and no sub-kernel (K1's team kernel, ``wide_gemm``);
   step seconds, each ``_orth2d`` shape's share of the step, peak memory.
17. spread: each full-width sweep (``caqr_factorize``, the state machine
   stepped and fused, the four-kill FT sweep, the online sweeps stepped,
   fused and double-buffered) run five times: median and min-max seconds.

The kernels line gives each kernel's launches on every path above, each
counted from 0 just before the path ran (on the spmd paths ``spmd``,
``spmd_kill``, ``spmd_mds`` and ``spmd_b256``, the sum of the ranks' own
counters); its ``wide_gemm`` record counts
the products' kernel's launches inside the wide calls
(``backend.SUB_LAUNCHES``: K2's and K4's wide routes; K1 and K3 launch no
sub-kernel, and the muon path none at all). The line before it holds the
wide phase's records of K1-K4.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Needs CUDA; imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import multiprocessing as mp
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

# cuBLAS reads its workspace setting when CUDA starts; the train phase's
# deterministic mode needs the fixed one
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core import SimComm, caqr_apply_qt, caqr_factorize, ft_tsqr  # noqa: E402
from repro_torch.core import block_row_layout, householder, panel_geometry, recovery  # noqa: E402
from repro_torch.core import sweep_geometry  # noqa: E402
from repro_torch.core.lstsq import caqr_lstsq  # noqa: E402
from repro_torch.ft import (  # noqa: E402
    FailureSchedule,
    MDSScheme,
    ScriptedKiller,
    Semantics,
    ft_caqr_sweep,
    ft_caqr_sweep_online,
    iter_sweep_points,
    sweep_point,
)
from repro_torch.ft.online import state as sm  # noqa: E402
from repro_torch.kernels import backend, build, ops, ref  # noqa: E402
from repro_torch.kernels import fused_sweep as tfs  # noqa: E402
from repro_torch.kernels import panel_qr as tpq  # noqa: E402
from repro_torch.kernels import stacked_qr as tsa  # noqa: E402
from repro_torch.kernels import wide  # noqa: E402
from repro_torch.kernels import wy_apply as twy  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig  # noqa: E402
from repro_torch.launch import spmd_qr  # noqa: E402
from repro_torch.launch.serve_qr import make_requests  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.serve import QRService  # noqa: E402
from repro_torch.train import TrainConfig, Trainer  # noqa: E402
from repro_torch.train.ftrun import (  # noqa: E402
    FTRunConfig,
    FTTrainer,
    StepSweepKiller,
    TrainingSuspended,
)
from repro_torch.train.ftrun.tasks import task_slice  # noqa: E402

P, M_LOC, N, B = 8, 4096, 4096, 128
L = P.bit_length() - 1
PEAK_FP32 = 67e12    # FLOP/s, H100 SXM outside the tensor cores
PEAK_BYTES = 3.35e12  # B/s, H100 SXM HBM3
GRAM_TOL = 1e-3       # relative, float64 Gram identity R^T R = A^T A
QTA_TOL = 1e-3        # relative to max |R|
LSTSQ_TOL = 1e-3      # relative to the normal-equations solution
# a panel column whose pivot is below this share of the largest depends on
# the columns before it to within f32 round-off over the f32 tolerance
# (1.2e-7 / 3e-4): its reflector is not fixed by the data
DEPENDENT_PIVOT = 4e-4

KERNELS = {
    "panel_qr": ("src/repro_torch/csrc/panel_qr.cu",
                 "src/repro/kernels/panel_qr.py:149"),
    "wy_apply": ("src/repro_torch/csrc/wy_apply.cu",
                 "src/repro/kernels/wy_apply.py:80"),
    "stacked_qr": ("src/repro_torch/csrc/stacked_qr.cu",
                   "src/repro/kernels/stacked_qr.py:108"),
    "stacked_apply": ("src/repro_torch/csrc/stacked_qr.cu",
                      "src/repro/kernels/stacked_qr.py:171"),
    "panel_qr_apply": ("src/repro_torch/csrc/fused_sweep.cu",
                       "src/repro/kernels/fused_sweep.py:226"),
    "fused_panel": ("src/repro_torch/csrc/fused_sweep.cu",
                    "src/repro/kernels/fused_sweep.py:167"),
}
STEPPED = ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply")
LATE_W = 512  # a late panel's window width (panel 28 of 32)
# the FT driver's four kills {point: lane}: an early leaf point, a tsqr and
# a trailing point mid-sweep (the latter of the root lane: every panel of
# the tall cell is rooted at lane 0) and the last panel's last point
KILLS = {sweep_point(1, "leaf"): 2,
         sweep_point(12, "tsqr", 1): 5,
         sweep_point(16, "trailing", 0): 0,
         sweep_point(N // B - 1, "trailing", L - 1): 7}
# fused boundaries are panel ends: the same lanes at the last point of the
# same four panels
PANEL_END_KILLS = {sweep_point(k, "trailing", L - 1): lane
                   for (k, _, _), lane in KILLS.items()}
SPREAD_RUNS = 5
# the spmd phase: one rank a lane, every collective through gloo; the
# (m_loc, n) of its MDS f = 2 cell (the scheduled driver re-encodes every
# protected leaf across the ranks at each point), that cell's two deaths,
# the point after which the tall matrix's parity is encoded across the
# ranks, and the group's timeout (collectives and each task)
SPMD_MDS = (512, 512)
SPMD_MDS_KILL = (sweep_point(2, "trailing", L - 1), [2, 5])
SPMD_PARITY_POINT = sweep_point(1, "leaf")
SPMD_TIMEOUT_S = 300.0
# the online runs over the ranks: the tall MDS f = 2 run's two non-buddy
# deaths on a panel boundary (its segments are whole panels, so one refresh
# a panel), and the elastic run's kill (lane, point): fold 8 -> 4
SPMD_ONLINE_MDS_KILL = (sweep_point(20, "trailing", L - 1), [2, 5])
SPMD_SHRINK_KILL = (3, sweep_point(8, "trailing", L - 1))
# single-process sweeps of the spread phase timed before and after it
SPMD_RESIDUE = ("caqr_factorize", "ft_sweep_four_kills",
                "online_async_four_kills")
# the serve phase: the larger bucket's tenants reach 32768 x 2046, 16 panels
SERVE_BUCKETS = ((1024, 1024), (4096, 2048))
SERVE_SLOTS = 8
SERVE_REQUESTS = 24
SERVE_LSTSQ_FRAC = 0.25
SERVE_KILL_LANE, SERVE_KILL_TICK = 2, 2
# requests a drain_batched call takes: four of the larger bucket's tenants
# with their bundles are about 9 GB, twice that while the batch is stacked
SERVE_GROUP = 4
# the train phase: TinyLlama-1.1B at its published width, cut in depth
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 2, 1024, 8, 4
TRAIN_LANES, TRAIN_B = 4, 128
TRAIN_LR, TRAIN_WARMUP = 1e-2, 1
TRAIN_REDUCED = {
    "n_layers": "22 -> 2: time (each layer adds 7 full-width sweeps a step)",
    "seq_len": "2048 -> 1024: time (the grad phase is not what is held here)",
    "global_batch": "8 rows over 4 data lanes: time",
    "steps": "4: enough for a loss that falls, a mid-step kill at step 2, "
             "a suspension inside step 2 and a lane death at step 3",
}
# the mid-sweep kill: lane 1, step 2, inside the first w_in sweep
TRAIN_KILL = dict(at_step=2, lane=1, task="groups/l0/ffn/.w_in#0",
                  point=sweep_point(8, "tsqr", 1))
TRAIN_FAIL = {3: [2]}     # the training-level lane death (REBUILD replay)
TRAIN_PSGD_RANK, TRAIN_PSGD_STEPS = 4, 2
# K1-K4's shapes on the train path (m_loc, n, b): the Muon sweeps of w_in,
# w_gate and w_out (5632 x 2048), of wq and wo (2048 x 2048) and of wk and
# wv (2048 x 256), then the PowerSGD projections (m x r) of wq-like,
# w_out-like and embedding slices
TRAIN_SHAPES = ((1408, 2048, 128), (512, 2048, 128), (512, 256, 128),
                (512, 4, 4), (1408, 4, 4), (8000, 4, 4))
# the MoE phase: mixtral-8x22b at its published width, cut in depth
MOE_ARCH = "mixtral-8x22b"
MOE_LAYERS, MOE_SEQ, MOE_BATCH, MOE_STEPS = 1, 1024, 8, 3
MOE_REDUCED = {
    "n_layers": "56 -> 1: memory and time (one layer's expert banks, 2.4 G "
                "parameters, with their float32 momentum and second moment "
                "and the trainer's step fill most of the card; each layer "
                "adds 29 full-width sweeps a step)",
    "seq_len": "4096 (the train_4k shape) -> 1024: time (the window of 4096 "
               "then masks nothing; the CPU tests hold the window)",
    "global_batch": "8 rows over 4 data lanes: time",
    "steps": "3: a kill inside step 2 and a step after it",
}
# the mid-sweep kill: lane 1, step 2, inside the fourth w_gate expert's sweep
# (48 panels), after panel 20's last butterfly level
MOE_KILL = dict(at_step=2, lane=1, task="groups/l0/ffn/.w_gate#3",
                point=sweep_point(20, "tsqr", 1))
# K1-K4's shapes on the MoE path (m_loc, n, b): the expert slices (16384 x
# 6144: w_gate and w_in transposed, w_out as it is), wq and wo (6144 x
# 6144), wk and wv (6144 x 1024), and the router (6144 x 8), whose sweep is
# one panel as wide as the matrix (the engine clamps b to n)
MOE_SHAPES = ((4096, 6144, 128), (1536, 6144, 128), (1536, 1024, 128),
              (1536, 8, 8))
MOE_ROUTER = "groups/l0/ffn/.w_router#0"   # the router's sweep task
MOE_SWEEPS = 29                            # sweeps a step (the tasks)
# the wide phase: K1-K4 above 128 columns (the blocked routes of
# kernels/wide.py) on the tall cell's matrix at b = 256 (16 panels)
WIDE_B = 256
# the wide FT sweep's two kills {point: lane}: a leaf point and a trailing
# point of the panel's root lane, mid-sweep
WIDE_KILLS = {sweep_point(3, "leaf"): 5, sweep_point(9, "trailing", 1): 0}
# the same lanes killed at those panels' ends, for the fused online sweep
WIDE_END_KILLS = {sweep_point(3, "trailing", L - 1): 5,
                  sweep_point(9, "trailing", L - 1): 0}
# K1 at the plain CAQR-Muon path's shapes at TinyLlama's width (m, b): wq and
# wo (one leaf), the MLP matrices made tall (one leaf), and wk and wv's
# leaf and chain steps ([R; tile] of 256 + 512 rows)
MUON_K1 = {"wq": (2048, 2048), "w_mlp": (5632, 2048), "wk_leaf": (512, 256),
           "wk_step": (768, 256)}
MUON_STEPS = 3
# launches of every kernel on every path, counters at 0 before each path
PATH_LAUNCHES = {}
# the wide paths' launches of the kernels inside a wide call
# (backend.SUB_LAUNCHES), from the same runs
PATH_SUB = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_us(event) -> float:
    us = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if us is None else us


def device_ms(fn, reps: int, kernel: str = ""):
    """Device time per call of ``fn``: the kernels' own time under
    torch.profiler over ``reps`` calls. Unlike ``time_ms`` it leaves out
    the host's time to issue each call, which bounds the eager time of a
    kernel shorter than about 0.05 ms. The trace must hold at least
    ``reps`` records of ``kernel`` (a name prefix; any kernel if empty):
    the profiler has been seen to drop records, so it tries three times,
    then gives None (not measured) rather than a short sum."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        seen = sum(e.count for e in events
                   if e.key.removeprefix("void ").startswith(kernel))
        if seen >= reps:
            return sum(_device_us(e) for e in events) / reps / 1e3
    return None


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def max_err(got, want):
    """(largest |got - want| over all outputs, the same with each output's
    difference over max(1, max|want|)); the second is held to the
    tolerance."""
    diffs = [(float((g - w).abs().max()), max(1.0, float(w.abs().max())))
             for g, w in zip(got, want)]
    return max(d for d, _ in diffs), max(d / s for d, s in diffs)


def as_tuple(x):
    if isinstance(x, dict):
        return tuple(x[f] for f in x if f != "tops")
    return x if isinstance(x, tuple) else (x,)


def same_bits(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(as_tuple(got), as_tuple(want)))


def wy_cost(P, m, b, n):
    """(FLOPs, bytes) of K2: Y^T C and Y W at 2mbn each, T^T W1 at b^2 n
    (T triangular, counted once); Y, T, C read and out written once."""
    return (P * (4.0 * m * b * n + b * b * n),
            4.0 * P * (m * b + b * b + 2 * m * n))


def sa_cost(P, b, n):
    """(FLOPs, bytes) of K4: three triangular products at b^2 n each;
    Y2, T, Ct, Cb read and ot, ob, W written once."""
    return P * 3.0 * b * b * n, 4.0 * P * (2 * b * b + 5 * b * n)


def wy_library(Y, T, C):
    return C - Y @ (T.mT @ (Y.mT @ C))


def sa_library(Y2, T2, Ct, Cb):
    W = T2.mT @ (Ct + Y2.mT @ Cb)
    return Ct - W, Cb - Y2 @ W, W


def ptxas(source: str, kernel: str) -> dict:
    """Registers and spill bytes of every instance of ``kernel`` (a
    ``__global__`` name) in the build log of ``source``."""
    out = {}
    for fn, use in build.resource_usage(pathlib.Path(source).stem).items():
        m = re.match(r"_Z(\d+)", fn)  # the name's length, then the name
        end = m.end() + int(m.group(1)) if m else 0
        if m and fn[m.end():end] == kernel:
            # template arguments: Li128E (int 128), Lb1E (true)
            tmpl = re.match(r"I((?:L[ib]\d+E)+)E", fn[end:])
            args = [v if t == "i" else ("false", "true")[int(v)]
                    for t, v in re.findall(r"L([ib])(\d+)E",
                                           tmpl.group(1) if tmpl else "")]
            out[kernel + (f"<{', '.join(args)}>" if args else "")] = use
    return out


def leaf_cost(P, m, b, rs):
    """(FLOPs, bytes) of K1 on P panels whose column loops start at row rs:
    3 m' b^2 - b^3 / 3 a lane over the m' = m - rs rows the loop touches;
    those rows read, Y (m x b), T and R written once."""
    ma = m - rs
    return (P * (3.0 * ma * b * b - b ** 3 / 3.0),
            4.0 * P * (ma * b + m * b + 2 * b * b))


def k1_record(panel: torch.Tensor, rs: int, reps: int) -> dict:
    """K1 on one lane's (m x b) panel at row start rs, beside the plain
    version and ``torch.geqrf`` of the rows the column loop touches."""
    m, b = panel.shape
    run = lambda: ops.panel_qr(panel, rs)  # noqa: E731
    active = panel[rs:].contiguous()
    lib = lambda: torch.geqrf(active)  # noqa: E731
    err, scaled = max_err(run(), ref.panel_qr(panel, rs))
    check(scaled <= ref.tolerances(torch.float32)[0],
          f"panel_qr: scaled error {scaled} at rs = {rs}")
    bms, by = bound_ms(*leaf_cost(1, m, b, rs))
    return dict(shape=[m, b], row_start=rs, team=backend.team_blocks(m, b),
                max_abs_err=err, scaled_err=scaled, ms=time_ms(run, reps),
                device_ms=device_ms(run, reps, "panel_qr_kernel"),
                bound_ms=bms, bound_by=by,
                library_ms=time_ms(lib, reps),
                library_device_ms=device_ms(lib, reps),
                library_shape=list(active.shape))


def team_record() -> dict:
    """K1's lane team at the tall and square cells' panels: its size,
    shared memory a block, and how many teams the card holds at once; the
    registers and spills of K1, K5 and K6 from their build logs."""
    out = {}
    for cell, m in (("tall", M_LOC), ("square", N // P)):
        C = backend.team_blocks(m, B)
        out[cell] = dict(m=m, b=B, team=C,
                         slab_in_smem=backend.team_slab_in_smem(m, B, C),
                         smem_bytes=tpq.smem_bytes(m, B, C),
                         max_active_clusters=tpq.max_active_clusters(m, B))
    out["ptxas"] = {**ptxas(KERNELS["panel_qr"][0], "panel_qr_kernel"),
                    **ptxas(KERNELS["fused_panel"][0], "panel_qr_apply_kernel"),
                    **ptxas(KERNELS["fused_panel"][0], "fused_panel_kernel")}
    return out


def shape_record(op: str, args: tuple, cost: tuple, lib, reps: int) -> dict:
    """One kernel at other shapes than the first panel's: time, bound,
    library time and error against the plain version."""
    run = getattr(ops, op)
    got, want = as_tuple(run(*args)), as_tuple(getattr(ref, op)(*args))
    err, scaled = max_err(got, want)
    del got, want
    check(scaled <= ref.tolerances(torch.float32)[0],
          f"{op}: scaled error {scaled} at {[tuple(a.shape) for a in args]}")
    bms, by = bound_ms(*cost)
    C = args[2]
    P = C.shape[0] if C.dim() == 3 else 1
    return dict(shapes=[list(a.shape) for a in args], bn=backend.tile_bn(
        P, C.shape[-1], backend.sm_count(0)),
        max_abs_err=err, scaled_err=scaled, ms=time_ms(lambda: run(*args), reps),
        device_ms=device_ms(lambda: run(*args), reps, op + "_kernel"),
        bound_ms=bms, bound_by=by, library_ms=time_ms(lambda: lib(*args), reps),
        library_device_ms=device_ms(lambda: lib(*args), reps))


def kernel_phase(A: torch.Tensor) -> list:
    """K1-K6 on the first panel's data of the sweep, against their plain
    versions; returns one record per kernel."""
    rtol, _ = ref.tolerances(torch.float32)
    f = 4.0  # bytes per float
    panel = A[..., :B].contiguous()
    rows = [(i, i ^ 1) for i in range(P)]
    C = A  # panel 0's live window is the whole width
    comm = SimComm(P)
    cases = {}
    Y, T, R = ops.panel_qr(panel, 0)
    leaf_flops = 3.0 * M_LOC * B * B - B ** 3 / 3.0
    apply_flops = 4.0 * M_LOC * B * N + B * B * N
    flops, nbytes = leaf_cost(P, M_LOC, B, 0)
    cases["panel_qr"] = dict(
        run=lambda: ops.panel_qr(panel, 0), plain=lambda: ref.panel_qr(panel, 0),
        lib=lambda: torch.geqrf(panel), flops=flops, nbytes=nbytes, reps=20)
    flops, nbytes = wy_cost(P, M_LOC, B, N)
    cases["wy_apply"] = dict(
        run=lambda: ops.wy_apply(Y, T, C), plain=lambda: ref.wy_apply(Y, T, C),
        lib=lambda: wy_library(Y, T, C), flops=flops, nbytes=nbytes, reps=10)
    R_top = R.contiguous()
    R_bot = R[[j for _, j in rows]].contiguous()
    Y2, T2, _ = ops.stacked_qr(R_top, R_bot)
    stack = torch.cat([R_top, R_bot], dim=1)
    cases["stacked_qr"] = dict(
        run=lambda: ops.stacked_qr(R_top, R_bot),
        plain=lambda: ref.stacked_qr(R_top, R_bot),
        lib=lambda: torch.geqrf(stack),
        flops=P * float(B ** 3), nbytes=f * P * 5 * B * B, reps=10)
    Ct = ops.wy_apply(Y, T, C)[:, :B].contiguous()
    Cb = Ct[[j for _, j in rows]].contiguous()
    flops, nbytes = sa_cost(P, B, N)
    cases["stacked_apply"] = dict(
        run=lambda: ops.stacked_apply(Y2, T2, Ct, Cb),
        plain=lambda: ref.stacked_apply(Y2, T2, Ct, Cb),
        lib=lambda: sa_library(Y2, T2, Ct, Cb), flops=flops, nbytes=nbytes,
        reps=10)

    def k1_k2():
        Yl, Tl, _ = ops.panel_qr(A[..., :B], 0)
        return ops.wy_apply(Yl, Tl, A)

    cases["panel_qr_apply"] = dict(
        run=lambda: ops.panel_qr_apply(A, 0, B),
        plain=lambda: ref.panel_qr_apply(A, 0, B),
        stepped=k1_k2, stepped_route="K1+K2 (panel_qr, wy_apply)",
        flops=P * (leaf_flops + apply_flops),
        nbytes=f * P * (2 * M_LOC * N + M_LOC * B + 2 * B * B + B * N),
        reps=3)
    s0 = sm.initial_sweep_state(comm, A, B)
    pts = sm.panel_points(s0.geom)
    cases["fused_panel"] = dict(
        run=lambda: ops.fused_panel(A, 0, b=B, m_loc_pad=M_LOC, levels=L),
        plain=lambda: ref.fused_panel(A, 0, b=B, m_loc_pad=M_LOC, levels=L),
        stepped=lambda: sm.run_steps(comm, s0, pts),
        stepped_route="the stepped panel (K1, 3 x K3, K2, 3 x K4)",
        flops=P * (leaf_flops + apply_flops + L * (B ** 3 + 3.0 * B * B * N)),
        nbytes=f * P * (2 * M_LOC * N + M_LOC * B + (3 + 2 * L) * B * B
                        + (1 + 3 * L) * B * N),
        reps=3)

    # Determinism: one lane of the P-lane launch equals a launch of it alone.
    k = P - 3
    check(same_bits(tuple(x[k] for x in (Y, T, R)), ops.panel_qr(panel[k], 0)),
          "panel_qr: lane bits depend on the launch")
    one = ops.stacked_qr(R_top[k], R_bot[k])
    check(all(torch.equal(a[k], o) for a, o in
              zip(ops.stacked_qr(R_top, R_bot), one)),
          "stacked_qr: lane bits depend on the launch")
    # K3 on a butterfly pair's stacks, as ft_tsqr_level gives them at level
    # 0: both lanes of a pair stack the same two R factors, top lane first.
    pair = ops.stacked_qr(R[[p & ~1 for p in range(P)]].contiguous(),
                          R[[p | 1 for p in range(P)]].contiguous())
    pair_bitwise = all(torch.equal(x[p], x[p ^ 1]) for x in pair for p in range(P))
    check(pair_bitwise, "stacked_qr: the two lanes of a butterfly pair differ")
    del pair
    one = ops.wy_apply(Y[k], T[k], C[k])
    check(torch.equal(ops.wy_apply(Y, T, C)[k], one),
          "wy_apply: lane bits depend on the launch")
    one = ops.stacked_apply(Y2[k], T2[k], Ct[k], Cb[k])
    check(all(torch.equal(a[k], o) for a, o in
              zip(ops.stacked_apply(Y2, T2, Ct, Cb), one)),
          "stacked_apply: lane bits depend on the launch")
    fused_leaf = ops.panel_qr_apply(A, 0, B)
    check(same_bits(tuple(x[k] for x in fused_leaf),
                    ops.panel_qr_apply(A[k], 0, B)),
          "panel_qr_apply: lane bits depend on the launch")
    # K5 shares K1's and K2's device code: bit-equal to the two launches.
    Yk, Tk, Rk = ops.panel_qr(A[..., :B], 0)
    Ck = ops.wy_apply(Yk, Tk, A)
    check(same_bits(fused_leaf, (Yk, Tk, Rk, Ck, Ck[:, :B])),
          "panel_qr_apply differs from panel_qr then wy_apply")
    del fused_leaf, Yk, Tk, Rk, Ck
    # K2 and K4: the column tile does not change the bits.
    bn_bitwise = {
        "wy_apply": same_bits(twy.wy_apply(Y, T, C, bn=32),
                              twy.wy_apply(Y, T, C, bn=128)),
        "stacked_apply": same_bits(tsa.stacked_apply(Y2, T2, Ct, Cb, bn=32),
                                   tsa.stacked_apply(Y2, T2, Ct, Cb, bn=128)),
    }
    check(all(bn_bitwise.values()), f"column tiles change the bits: {bn_bitwise}")
    # K2 and K4 at a late panel's window and on one lane (a REBUILD replay)
    late = N - LATE_W
    Ctl, Cbl = Ct[..., :LATE_W].contiguous(), Cb[..., :LATE_W].contiguous()
    other_shapes = {
        "panel_qr": {
            "one_lane": k1_record(panel[k], 0, 20),
            "late_panel": k1_record(panel[0], M_LOC - B, 50)},
        "wy_apply": {
            "late_panel": shape_record("wy_apply", (Y, T, A[..., late:]),
                                       wy_cost(P, M_LOC, B, LATE_W), wy_library, 20),
            "one_lane": shape_record("wy_apply", (Y[k], T[k], A[k]),
                                     wy_cost(1, M_LOC, B, N), wy_library, 20)},
        "stacked_apply": {
            "late_panel": shape_record("stacked_apply", (Y2, T2, Ctl, Cbl),
                                       sa_cost(P, B, LATE_W), sa_library, 50),
            "one_lane": shape_record("stacked_apply", (Y2[k], T2[k], Ct[k], Cb[k]),
                                     sa_cost(1, B, N), sa_library, 50)},
    }
    del Ctl, Cbl

    records = []
    for name, c in cases.items():
        got, want = c["run"](), c["plain"]()
        torch.cuda.synchronize()
        err, scaled = max_err(as_tuple(got), as_tuple(want))
        del got, want
        check(scaled <= rtol, f"{name}: scaled error {scaled} over tolerance {rtol}")
        ms = time_ms(c["run"], c["reps"])
        slow_plain = name in ("panel_qr", "panel_qr_apply", "fused_panel")
        plain_ms = time_ms(c["plain"], 1 if slow_plain else c["reps"])
        bms, by = bound_ms(c["flops"], c["nbytes"])
        source, replaces = KERNELS[name]
        rec = dict(name=name, route="cuda", source=source, replaces=replaces,
                   launches=0, max_abs_err=err, scaled_err=scaled,
                   tolerance=rtol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by,
                   library_ms=time_ms(c["lib"], c["reps"]) if "lib" in c else None)
        rec["device_ms"] = device_ms(c["run"], c["reps"], name + "_kernel")
        if "lib" in c:
            rec["library_device_ms"] = device_ms(c["lib"], c["reps"])
        if "stepped" in c:
            # no single PyTorch call computes K5 or K6: the yardstick is the
            # stepped kernels doing the same work
            rec["stepped_ms"] = time_ms(c["stepped"], c["reps"])
            rec["stepped_route"] = c["stepped_route"]
        if name == "stacked_qr":
            rec["smem_bytes"] = tsa.smem_bytes(B)
            rec["pair_bitwise"] = pair_bitwise
        if name == "fused_panel":
            bn = backend.tile_bn(P, N, backend.sm_count(0))
            rec["smem_bytes"] = tfs.smem_bytes(M_LOC, B, bn)
            rec["blocks_per_sm"] = tfs.blocks_per_sm(M_LOC, B, bn)
        if name in other_shapes:
            if name in bn_bitwise:
                rec["bn"] = backend.tile_bn(P, N, backend.sm_count(0))
                rec["bn_bitwise"] = bn_bitwise[name]
            rec.update(other_shapes[name])
        rec["ptxas"] = ptxas(source, name + "_kernel")
        emit({"kernel": rec})
        records.append(rec)
    return records


def gram_error(A_flat64: torch.Tensor, R: torch.Tensor) -> float:
    G = A_flat64.T @ A_flat64
    R64 = R.double()
    return float((R64.T @ R64 - G).abs().max() / G.abs().max())


def sweep_phase(A: torch.Tensor, rng):
    """The slice-1 main path, launch counters at 0 before it; returns the
    launches, the sweep's seconds and its (R, factors, bundles)."""
    comm = SimComm(P)
    backend.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = caqr_factorize(A, comm, B, use_scan=False, collect_bundles=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(backend.LAUNCHES)
    check(all(launches[op] > 0 for op in STEPPED),
          f"a kernel was not launched by the sweep: {launches}")
    check(bool((res.R == res.R[:1]).all()), "R is not replicated bitwise")
    m = P * M_LOC
    flops = 2.0 * m * N * N - 2.0 * N ** 3 / 3.0
    A64 = A.reshape(-1, N).double()
    R0 = res.R[0]
    gram = gram_error(A64, R0)
    check(gram <= GRAM_TOL, f"Gram identity: {gram} > {GRAM_TOL}")
    QtA = caqr_apply_qt(A, res.factors, comm).reshape(-1, N)
    rmax = float(R0.abs().max())
    top = float((QtA[:N] - R0).abs().max()) / rmax
    rest = float(QtA[N:].abs().max()) / rmax
    del QtA
    check(max(top, rest) <= QTA_TOL, f"Q^T A != [R; 0]: {top}, {rest}")
    rhs = block_row_layout(rng.standard_normal((m, 1)).astype(np.float32), P)
    x = caqr_lstsq(A, rhs, comm, B, result=res._replace(bundles=None)).double()
    b64 = rhs.reshape(-1, 1).double()
    x_ne = torch.linalg.solve(A64.T @ A64, A64.T @ b64)
    lst = float((x - x_ne).norm() / x_ne.norm())
    check(lst <= LSTSQ_TOL, f"lstsq vs normal equations: {lst}")
    out = dict(shape=[m, N], P=P, b=B, panels=N // B, levels=L,
               seconds=seconds, gflops=flops / seconds / 1e9,
               launches=launches, gram_rel_err=gram, qta_top_rel_err=top,
               qta_rest_rel=rest, lstsq_rel_err=lst,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    emit({"sweep": out})
    PATH_LAUNCHES["sweep"] = dict(launches)
    return launches, seconds, res


def profile_phase(A: torch.Tensor, sweep_seconds: float) -> None:
    """Device time by kernel over the same sweep run once more under
    torch.profiler: where the sweep's time goes. The tracer slows the host
    several-fold, so the busy share is taken against the unprofiled
    sweep's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        caqr_factorize(A, SimComm(P), B, use_scan=False, collect_bundles=True)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, other = device_time_by_kernel(prof)
    busy = sum(by_kernel.values()) + other
    emit({"profile": dict(profiled_wall_ms=wall_ms, kernel_ms=by_kernel,
                          other_device_ms=other, device_ms=busy,
                          device_busy_share=busy / (sweep_seconds * 1e3))})


def device_time_by_kernel(prof):
    """(ms of K1-K4 by name, ms of every other device op) in a
    torch.profiler trace."""
    by_kernel = {name: 0.0 for name in STEPPED}
    other = 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = _device_us(e)
        key = e.key.removeprefix("void ")  # templated kernels carry it
        name = next((k for k in STEPPED if key.startswith(k + "_kernel")), None)
        if name is None:
            other += us / 1e3
        else:
            by_kernel[name] += us / 1e3
    return by_kernel, other


def fused_leaf_phase(A: torch.Tensor) -> dict:
    """K5's path: the fused leaf entry point on the first panel's window,
    counters at 0 before it; bit-equal to the stepped leaf (K1 then K2)."""
    comm = SimComm(P)
    _c0, _t, row_start, _act = panel_geometry(comm, 0, B, M_LOC)
    backend.reset_launches()
    wy, C, Cp = householder.panel_qr_apply(A, row_start, B)
    torch.cuda.synchronize()
    launches = dict(backend.LAUNCHES)
    wy1 = householder.householder_qr_masked(A[..., :B], row_start)
    C1 = householder.apply_qt(wy1.Y, wy1.T, A)
    same = same_bits((*wy, C, Cp), (*wy1, C1, C1[:, :B]))
    emit({"fused_leaf": dict(window=list(A.shape), launches=launches,
                             bitwise_equal_stepped=same)})
    PATH_LAUNCHES["fused_leaf"] = launches
    check(launches["panel_qr_apply"] == 1 and
          all(launches[op] == 0 for op in STEPPED),
          f"fused leaf launches: {launches}")
    check(same, "fused leaf differs from the stepped leaf")
    return launches


def states_equal(a: sm.SweepState, b: sm.SweepState) -> bool:
    fa, fb = sm.flat_arrays(a), sm.flat_arrays(b)
    return (a.cursor == b.cursor and fa.keys() == fb.keys()
            and all(fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
                    for k in fa))


def lockstep(A: torch.Tensor, b: int = B) -> int:
    """Fused and stepped sweeps at panel width ``b`` side by side; checks
    the states bit for bit at every panel boundary and the finalized
    outputs; returns the number of boundaries compared."""
    comm = SimComm(P)
    s_f = s_s = sm.initial_sweep_state(comm, A, b)
    pts = sm.panel_points(s_s.geom)
    n = 0
    while s_f.cursor is not None:
        s_f = sm.run_panel_fused(comm, s_f)
        s_s = sm.run_steps(comm, s_s, pts)
        check(states_equal(s_f, s_s),
              f"fused state differs from stepped at boundary {s_s.cursor}")
        n += 1
    check(same_bits(flat_result(sm.finalize(comm, s_f)),
                    flat_result(sm.finalize(comm, s_s))),
          "fused and stepped finalize differ")
    return n


def flat_result(res) -> tuple:
    R, factors, bundles = res[:3]
    return (R, *factors, *bundles)


def timed_sweep(A: torch.Tensor, fused: bool, b: int = B):
    """One state-machine sweep at panel width ``b`` to completion with
    finalize, counters and peak memory reset before it; returns (result,
    seconds, launches, GB): the peak is counted above what was allocated
    before the sweep."""
    comm = SimComm(P)
    s = sm.initial_sweep_state(comm, A, b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    t0 = time.perf_counter()
    if fused:
        while s.cursor is not None:
            s = sm.run_panel_fused(comm, s)
    else:
        s = sm.run_steps(comm, s)
    out = sm.finalize(comm, s)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del s
    return (out, seconds, dict(backend.LAUNCHES),
            (torch.cuda.max_memory_allocated() - base) / 1e9)


def state_machine_phase(A: torch.Tensor, want: tuple) -> dict:
    """K6's path: the full-width sweep stepped and fused, each alone
    (seconds, launches, peak memory) and bit-equal to the sweep's
    outputs, then side by side, equal at every panel boundary."""
    res_s, sec_s, launch_s, mem_s = timed_sweep(A, fused=False)
    ok_s = same_bits(flat_result(res_s), want)
    del res_s
    res_f, sec_f, launch_f, mem_f = timed_sweep(A, fused=True)
    ok_f = same_bits(flat_result(res_f), want)
    del res_f
    boundaries = lockstep(A)
    PATH_LAUNCHES["state_machine_stepped"] = launch_s
    PATH_LAUNCHES["state_machine_fused"] = launch_f
    emit({"state_machine": dict(
        shape=[P * M_LOC, N], stepped_seconds=sec_s, fused_seconds=sec_f,
        stepped_launches=launch_s, fused_launches=launch_f,
        stepped_peak_mem_gb_above_live=mem_s,
        fused_peak_mem_gb_above_live=mem_f,
        stepped_equals_sweep=ok_s, fused_equals_sweep=ok_f,
        boundaries_bitwise=boundaries)})
    check(ok_s, "stepped state machine differs from caqr_factorize")
    check(ok_f, "fused sweep differs from caqr_factorize")
    check(launch_f["fused_panel"] == N // B and
          all(launch_f[op] == 0 for op in STEPPED),
          f"fused sweep launches: {launch_f}")
    check(all(launch_s[op] > 0 for op in STEPPED) and
          launch_s["fused_panel"] == 0, f"stepped launches: {launch_s}")
    return launch_f


def kill_check(A: torch.Tensor, comm, kills: dict, want: tuple,
               b: int = B) -> dict:
    """ft_caqr_sweep at panel width ``b`` under ``kills`` ({point: lane});
    bit-equal to ``want``, one single-source event per kill."""
    sched = FailureSchedule(events={pt: [lane] for pt, lane in kills.items()})
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    got = ft_caqr_sweep(A, comm, b, schedule=sched)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    same = same_bits(flat_result(got), want)
    events = [dict(point=list(e.point), lane=e.lane, reads=e.reads,
                   rebuild_seconds=e.elapsed_s) for e in got.events]
    check([(tuple(e["point"]), e["lane"]) for e in events] == list(kills.items()),
          f"events {events} do not match the kills {kills}")
    check(all(e["lane"] not in e["reads"].values() for e in events),
          "a rebuild read from the dead lane")
    check(same, "the FT sweep with kills differs from the failure-free sweep")
    return dict(seconds=seconds, events=events, bitwise_equal=same,
                launches=dict(backend.LAUNCHES), ledger=ledger(got.events))


def ledger(events) -> list:
    """(point, lane, reads) of each RecoveryEvent."""
    return [(tuple(e.point), e.lane, dict(e.reads)) for e in events]


def ft_driver_phase(A: torch.Tensor, want: tuple) -> dict:
    """The scheduled FT sweep with the four kills and, for the fused online
    run, with the same lanes killed at those panels' ends; returns both
    event ledgers."""
    out = kill_check(A, SimComm(P), KILLS, want)
    ends = kill_check(A, SimComm(P), PANEL_END_KILLS, want)
    PATH_LAUNCHES["ft_driver"] = out["launches"]
    ledgers = {"kills": out.pop("ledger"),
               "panel_end_kills": ends.pop("ledger")}
    emit({"ft_driver": dict(shape=[P * M_LOC, N], **out,
                            panel_end_kills=dict(
                                seconds=ends["seconds"],
                                events=ends["events"]))})
    return ledgers


class TimedScheme:
    """A coding scheme that times each ``refresh`` (the device synchronised
    before and after) and records the parity's bytes; everything else is
    the wrapped scheme's."""

    def __init__(self, inner):
        self.inner = inner
        self.name, self.f, self.joint = inner.name, inner.f, inner.joint
        self.seconds = []
        self.parity_bytes = 0

    def refresh(self, comm, state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner.refresh(comm, state)
        torch.cuda.synchronize()
        self.seconds.append(time.perf_counter() - t0)
        self.parity_bytes = max(self.parity_bytes,
                                sum(c.numel() for c in out.code))
        return out

    def decode_lanes(self, comm, state, newly, dead):
        return self.inner.decode_lanes(comm, state, newly, dead)


def online_run(A: torch.Tensor, kills: dict, b: int = B, **kw):
    """``ft_caqr_sweep_online`` on the tall cell at panel width ``b`` with a
    ``ScriptedKiller`` at ``kills`` ({point: [lanes]}), launch counters at 0
    just before it and peak memory counted above what was live; returns
    (result, the orchestrator's statistics, seconds, launches, peak GB)."""
    seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    t0 = time.perf_counter()
    res = ft_caqr_sweep_online(
        A, SimComm(P), b, fault_hooks=[ScriptedKiller(kills)],
        boundary_hooks=[lambda orch: seen.append(orch)], **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    orch = seen[-1]
    stats = dict(seconds=seconds, segments_run=orch.segments_run,
                 boundaries=orch.boundaries, poll_s=orch.poll_s,
                 recover_s=orch.recover_s,
                 peak_mem_gb_above_live=(torch.cuda.max_memory_allocated()
                                         - base) / 1e9)
    return res, stats, dict(backend.LAUNCHES)


def online_phase(A: torch.Tensor, want: tuple, ledgers: dict) -> None:
    """The online path on the tall cell: stepped and fused without a
    death; stepped with the FT driver's four kills, fused with the same
    lanes killed at those panels' ends, and stepped with double-buffered
    segments; each bit-equal to the failure-free sweep (so to the
    scheduled runs, which equal it too) with the scheduled run's event
    ledger. Then fused under MDSScheme(f=2) with
    two simultaneous non-buddy deaths at one boundary, decoded jointly."""
    kills = {pt: [lane] for pt, lane in KILLS.items()}
    ends = {pt: [lane] for pt, lane in PANEL_END_KILLS.items()}
    out = {}
    for path, k, led, kw in (
            ("online_stepped_failure_free", {}, [], {}),
            ("online_fused_failure_free", {}, [], dict(fused=True)),
            ("online_stepped", kills, ledgers["kills"], {}),
            ("online_fused", ends, ledgers["panel_end_kills"], dict(fused=True)),
            ("online_async", kills, ledgers["kills"],
             dict(async_segments=True))):
        res, stats, launches = online_run(A, k, **kw)
        same = same_bits(flat_result(res), want)
        got_ledger = ledger(res.events)
        del res
        PATH_LAUNCHES[path] = launches
        out[path] = dict(stats, bitwise_equal_scheduled=same,
                         ledger_equal_scheduled=got_ledger == led,
                         launches=launches)
        check(same, f"{path}: differs from the scheduled sweep")
        check(got_ledger == led, f"{path}: ledger {got_ledger} != {led}")
        if kw.get("fused"):
            check(launches["fused_panel"] == N // B and
                  (k or all(launches[op] == 0 for op in STEPPED)),
                  f"{path}: K6 launches {launches}")
        else:
            check(all(launches[op] > 0 for op in STEPPED)
                  and launches["fused_panel"] == 0,
                  f"{path}: launches {launches}")
    emit({"online": dict(shape=[P * M_LOC, N], **out)})

    pair = [2, 5]  # no butterfly level pairs them
    point = sweep_point(20, "trailing", L - 1)
    scheme = TimedScheme(MDSScheme(f=2))
    res, stats, launches = online_run(A, {point: pair}, fused=True,
                                      scheme=scheme)
    same = same_bits(flat_result(res), want)
    events = [dict(point=list(e.point), lane=e.lane, reads=e.reads,
                   decode_seconds=e.elapsed_s) for e in res.events]
    del res
    PATH_LAUNCHES["online_mds"] = launches
    sec = sorted(scheme.seconds)
    emit({"online_mds": dict(
        f=2, killed=pair, point=list(point), **stats,
        refresh_seconds_median=sec[len(sec) // 2],
        refresh_seconds_min=sec[0], refresh_seconds_max=sec[-1],
        refreshes=len(sec), parity_bytes_max=scheme.parity_bytes,
        events=events, bitwise_equal_failure_free=same, launches=launches)})
    check(same, "MDS joint decode differs from the failure-free sweep")
    check([e["lane"] for e in events] == pair and
          all(e["reads"].get("coded.parity1") == P + 1 for e in events),
          f"MDS events are not a joint decode: {events}")
    check(launches["fused_panel"] == N // B, f"online_mds launches {launches}")


def spmd_ranks(group, seconds: float) -> dict:
    """One spmd run's record: its seconds and each rank's report (seconds,
    launches, collectives, bytes staged through host memory and sent
    through gloo); checks that K1-K4 ran on every rank."""
    reps = group.last_reports
    for r in reps:
        check(all(r.launches[op] > 0 for op in STEPPED),
              f"rank {r.rank} did not launch K1-K4: {r.launches}")
    return dict(seconds=seconds, ranks=[r._asdict() for r in reps])


def spmd_launches(group, parent=None) -> dict:
    """The ranks' launches of one run, summed by kernel, and the parent's
    (``parent``, counted from 0 before the run) where it launched too."""
    parent = parent or {}
    return {op: sum(r.launches[op] for r in group.last_reports)
            + parent.get(op, 0) for op in backend.OPS}


def spmd_timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def sim_parity(A: torch.Tensor, b: int, point) -> tuple:
    """The single-process ``MDSScheme(f=2)`` parity after ``point``."""
    comm = SimComm(P)
    s = sm.initial_sweep_state(comm, A, b)
    pts = list(iter_sweep_points(s.geom.n_panels, s.geom.levels))
    s = sm.run_steps(comm, s, pts.index(point) + 1)
    return MDSScheme(f=2).refresh(comm, s).code


def spmd_online(group, Af: torch.Tensor, kills: dict, elastic: bool = False,
                **kw):
    """``ft_caqr_sweep_online_spmd`` (or ``ft_caqr_sweep_elastic_spmd``) on
    the whole matrix ``Af`` with a ``ScriptedKiller`` at ``kills``; returns
    (result, record): seconds, the orchestrator's segments and boundaries,
    the points the ranks ran, the parent's seconds a point outside the
    ranks (everything but the wait for their answers: the orchestrator's
    refresh, hooks, poll and recovery and the runner's shipping and
    joins), the parent's peak memory above what was live and the card's
    use after, the parent's own launches (REBUILD replays), the runners'
    account and each rank's report."""
    seen = []
    entry = (spmd_qr.ft_caqr_sweep_elastic_spmd if elastic
             else spmd_qr.ft_caqr_sweep_online_spmd)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    res, sec = spmd_timed(lambda: entry(
        Af, B, group=group, fault_hooks=[ScriptedKiller(kills)],
        boundary_hooks=[seen.append], **kw))
    orch, steps = seen[-1], group.last_steps
    free, total = torch.cuda.mem_get_info()
    return res, dict(
        spmd_ranks(group, sec),
        parent_peak_gb_above_live=(torch.cuda.max_memory_allocated() - base)
        / 1e9, card_used_gb_after=(total - free) / 1e9,
        parent_launches=dict(backend.LAUNCHES),
        segments_run=orch.segments_run,
        boundaries=orch.boundaries, points=steps["points"],
        parent_seconds_per_point=(sec - steps["rank_seconds"])
        / steps["points"],
        poll_s=orch.poll_s, recover_s=orch.recover_s, runner=steps)


def row_signs_close(R: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |R - want| after each row's sign is fixed by its
    diagonal, over the f32 tolerance (atol + rtol |want|): at most 1
    passes."""
    def fix(X):
        s = torch.sign(torch.diagonal(X))
        return X * torch.where(s == 0, torch.ones_like(s), s)[:, None]

    rtol, atol = ref.tolerances(torch.float32)
    R, want = fix(R.double()), fix(want.double())
    return float(((R - want).abs() / (atol + rtol * want.abs())).max())


def spmd_online_phase(group, A: torch.Tensor, want: tuple,
                      ledgers: dict) -> dict:
    """The online and elastic paths over the ranks on the tall matrix: the
    host orchestrator here holds the global state, each rank runs one
    ``sweep_step`` a point. Failure-free and with the FT driver's four
    kills (bit-equal to the failure-free sweep, so to the scheduled runs,
    the ledger equal to the scheduled run's); ``MDSScheme(f=2)`` with two
    simultaneous non-buddy deaths, a panel a segment (bit-equal to
    failure-free and to the single-process online run with the same hooks
    and segments, the same ledger, a joint decode); SHRINK with one kill,
    fold 8 -> 4 (R bit-equal to the single-process online run, its
    transitions and ledger, and within the f32 tolerance of the
    failure-free R up to row signs)."""
    Af = A.reshape(-1, N)
    out = {}
    # the parent holds the global state now and the ranks their slices:
    # give the card back what the parent's allocator keeps cached
    torch.cuda.empty_cache()
    for path, kills, led in (
            ("online_free", {}, []),
            ("online_kills", {pt: [lane] for pt, lane in KILLS.items()},
             ledgers["kills"])):
        res, rec = spmd_online(group, Af, kills)
        same = same_bits(flat_result(res), want)
        got = ledger(res.events)
        del res
        torch.cuda.empty_cache()
        PATH_LAUNCHES[f"spmd_{path}"] = spmd_launches(
            group, rec["parent_launches"])
        out[path] = dict(rec, bitwise_equal_scheduled=same,
                         ledger_equal_scheduled=got == led)
        check(same, f"spmd {path} differs from the scheduled sweep")
        check(got == led, f"spmd {path} ledger {got} != {led}")

    point, pair = SPMD_ONLINE_MDS_KILL
    seg = sm.panel_points(sweep_geometry(P, M_LOC, N, B))
    scheme = TimedScheme(MDSScheme(f=2))
    res, rec = spmd_online(group, Af, {point: pair}, scheme=scheme,
                           segment_points=seg)
    t0 = time.perf_counter()
    one = ft_caqr_sweep_online(
        A, SimComm(P), B, fault_hooks=[ScriptedKiller({point: pair})],
        scheme=MDSScheme(f=2), segment_points=seg)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    same = same_bits(flat_result(res), want)
    same_one = same_bits(flat_result(res), flat_result(one))
    led_same = ledger(res.events) == ledger(one.events)
    events = [dict(lane=e.lane, reads=e.reads, decode_seconds=e.elapsed_s)
              for e in res.events]
    del res, one
    torch.cuda.empty_cache()
    PATH_LAUNCHES["spmd_online_mds"] = spmd_launches(
        group, rec["parent_launches"])
    sec = sorted(scheme.seconds)
    out["online_mds"] = dict(
        rec, f=2, killed=pair, point=list(point), segment_points=seg,
        refreshes=len(sec), refresh_seconds_median=sec[len(sec) // 2],
        refresh_seconds_min=sec[0], refresh_seconds_max=sec[-1],
        parity_bytes_max=scheme.parity_bytes, events=events,
        single_process_seconds=one_s, bitwise_equal_failure_free=same,
        bitwise_equal_single_process=same_one,
        ledger_equal_single_process=led_same)
    check(same and same_one,
          "spmd online MDS differs from failure-free or the single process")
    check(led_same, "spmd online MDS ledger differs from the single process")
    check([e["lane"] for e in events] == pair and
          all(e["reads"].get("coded.parity1") == P + 1 for e in events),
          f"spmd online MDS events are not a joint decode: {events}")

    lane, point = SPMD_SHRINK_KILL
    res, rec = spmd_online(group, Af, {point: [lane]}, elastic=True)
    t0 = time.perf_counter()
    one = ft_caqr_sweep_online(
        A, SimComm(P), B, fault_hooks=[ScriptedKiller({point: [lane]})],
        semantics=Semantics.SHRINK, elastic_policy="fold")
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    same = torch.equal(res.R, one.R)
    trans = res.transitions == one.transitions and res.world == one.world
    led_same = ledger(res.events) == ledger(one.events)
    scaled = row_signs_close(res.R, want[0][0])
    (t,) = res.transitions
    PATH_LAUNCHES["spmd_elastic"] = spmd_launches(
        group, rec["parent_launches"])
    out["elastic_shrink"] = dict(
        rec, killed=lane, point=list(point), frontier=t.frontier,
        world_after=dict(n_slots=t.world_after.n_slots,
                         live=list(t.world_after.live)),
        single_process_seconds=one_s, R_bitwise_single_process=same,
        transitions_equal=trans, ledger_equal=led_same,
        R_scaled_err_failure_free=scaled)
    del res, one
    check(same, "spmd SHRINK R differs from the single-process online R")
    check(trans and led_same, "spmd SHRINK transitions or ledger differ")
    check(t.world_after.n_slots == P // 2 and rec["runner"]["worlds"]
          == [P, P // 2], f"spmd SHRINK worlds {rec['runner']['worlds']}")
    check(scaled <= 1.0, f"spmd SHRINK R vs failure-free: {scaled} x tol")
    return out


def spmd_phase(A: torch.Tensor, want: tuple, ledgers: dict, seed: int,
               device: str = "cuda") -> None:
    """One process per lane on the one card (see the module docstring);
    counters of each run are the ranks' own, counted from 0 at its start."""
    rng = np.random.default_rng([seed, 8])
    Af = A.reshape(-1, N)
    sweeps = spread_sweeps(A)
    out = {"single_process_before": {name: spread_times(sweeps[name])
                                     for name in SPMD_RESIDUE}}
    t0 = time.perf_counter()
    with spmd_qr.make_lane_group(P, device=device,
                                 timeout_s=SPMD_TIMEOUT_S) as group:
        out["spawn_seconds"] = time.perf_counter() - t0

        res, sec = spmd_timed(lambda: spmd_qr.caqr_factorize_lanes(
            Af, B, group, use_scan=False))
        same = torch.equal(res.R, want[0])
        gram = gram_error(Af.double(), res.R[0])
        out["caqr"] = dict(spmd_ranks(group, sec), r_bitwise_equal=same,
                           gram_rel_err=gram)
        PATH_LAUNCHES["spmd"] = spmd_launches(group)
        del res
        check(same, "spmd R differs from the single-process sweep's")
        check(gram <= GRAM_TOL, f"spmd Gram identity: {gram}")

        rhs = rng.standard_normal((P * M_LOC, 1)).astype(np.float32)
        x, sec = spmd_timed(lambda: spmd_qr.caqr_lstsq_lanes(
            Af, torch.from_numpy(rhs).to(A.device), B, group))
        A64 = Af.double()
        b64 = torch.from_numpy(rhs).to(A.device).double()
        x_ne = torch.linalg.solve(A64.T @ A64, A64.T @ b64)
        lst = float((x.double() - x_ne).norm() / x_ne.norm())
        del A64
        out["lstsq"] = dict(spmd_ranks(group, sec), rel_err=lst)
        check(lst <= LSTSQ_TOL, f"spmd lstsq vs normal equations: {lst}")

        sched = FailureSchedule(events={pt: [lane] for pt, lane in KILLS.items()})
        got, sec = spmd_timed(lambda: spmd_qr.ft_caqr_sweep_spmd(
            Af, B, sched, group=group))
        same = same_bits(flat_result(got), want)
        led = ledger(got.events)
        del got
        out["ft_kills"] = dict(spmd_ranks(group, sec), bitwise_equal=same,
                               ledger_equal_single_process=led == ledgers["kills"])
        PATH_LAUNCHES["spmd_kill"] = spmd_launches(group)
        check(same, "spmd FT sweep with kills differs from failure-free")
        check(led == ledgers["kills"], f"spmd ledger {led} != {ledgers['kills']}")

        code, sec = spmd_timed(lambda: spmd_qr.mds_parity_lanes(
            Af, B, 2, SPMD_PARITY_POINT, group))
        same = same_bits(code, sim_parity(A, B, SPMD_PARITY_POINT))
        out["parity_tall"] = dict(
            point=list(SPMD_PARITY_POINT), seconds=sec,
            parity_bytes=sum(c.numel() for c in code), bytes_equal=same,
            ranks=[r._asdict() for r in group.last_reports])
        del code
        check(same, "spmd parity differs from the single-process encode")

        m_loc, n = SPMD_MDS
        Am = rng.standard_normal((P * m_loc, n)).astype(np.float32)
        As = block_row_layout(Am, P, device=device)
        point, pair = SPMD_MDS_KILL
        msched = FailureSchedule(events={point: pair})
        free = caqr_factorize(As, SimComm(P), B, collect_bundles=True,
                              use_scan=False)
        sim = ft_caqr_sweep(As, SimComm(P), B, schedule=msched,
                            scheme=MDSScheme(f=2))
        got, sec = spmd_timed(lambda: spmd_qr.ft_caqr_sweep_spmd(
            As.reshape(-1, n), B, msched, group=group, scheme=MDSScheme(f=2)))
        ranks = spmd_ranks(group, sec)
        PATH_LAUNCHES["spmd_mds"] = spmd_launches(group)
        same = same_bits(flat_result(got), flat_result(free))
        led_same = ledger(got.events) == ledger(sim.events)
        code = spmd_qr.mds_parity_lanes(As.reshape(-1, n), B, 2, point, group)
        par_same = same_bits(code, sim_parity(As, B, point))
        out["mds"] = dict(ranks, shape=[P * m_loc, n],
                          killed=pair, point=list(point), bitwise_equal=same,
                          ledger_equal_single_process=led_same,
                          parity_bytes_equal=par_same,
                          joint=[e.lane for e in got.events
                                 if e.reads.get("coded.parity1") == P + 1])
        check(same, "spmd MDS decode differs from failure-free")
        check(led_same, "spmd MDS ledger differs from the single-process one")
        check(par_same, "spmd MDS parity differs from the single-process one")
        check(out["mds"]["joint"] == pair, f"not a joint decode: {got.events}")
        del got, sim, free

        R256 = caqr_factorize(A, SimComm(P), WIDE_B, use_scan=False).R
        res, sec = spmd_timed(lambda: spmd_qr.caqr_factorize_lanes(
            Af, WIDE_B, group, use_scan=False))
        same = torch.equal(res.R, R256)
        del res, R256
        out["caqr_b256"] = dict(spmd_ranks(group, sec), r_bitwise_equal=same)
        PATH_LAUNCHES["spmd_b256"] = spmd_launches(group)
        if group.device.type == "cuda":
            # (cluster, grid) of the one wide launch, cluster 0 a plain
            # cooperative grid: K1 and K3 of one rank's lane, and K1 of the
            # single process (a card's query; the CPU has no such launch)
            out["caqr_b256"].update(
                k1_launch_each_rank=group.run(tpq.wide_launch_shape, 1,
                                              M_LOC, WIDE_B),
                k3_launch_each_rank=group.run(tpq.wide_launch_shape, 1,
                                              2 * WIDE_B, WIDE_B),
                k1_launch_single_process=tpq.wide_launch_shape(P, M_LOC,
                                                               WIDE_B))
        check(same, "spmd R at b = 256 differs from the single-process one")
        out.update(spmd_online_phase(group, A, want, ledgers))
    out["phase_seconds"] = time.perf_counter() - t0
    left = mp.active_children()
    check(not left, f"rank processes outlived their group: {left}")
    # the ranks' results were shared by CUDA IPC: release what this
    # process still maps of them, and the blocks its copies freed
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    out["single_process_after"] = {name: spread_times(sweeps[name])
                                   for name in SPMD_RESIDUE}
    emit({"spmd": dict(shape=[P * M_LOC, N], P=P, b=B, **out)})


def shrunk_kernel_check(device, m: int, w: int) -> dict:
    """K1 and K6 at the shrunken world's padded lane height against their
    plain versions (random data from a seeded generator), and their
    times."""
    g = torch.Generator().manual_seed(1)
    X = torch.randn(P, m, w, generator=g).to(device)
    tol = ref.tolerances(torch.float32)[0]
    out = {}
    for name, run, plain in (
            ("panel_qr", lambda: ops.panel_qr(X[..., :B].contiguous(), 0),
             lambda: ref.panel_qr(X[..., :B].contiguous(), 0)),
            ("fused_panel",
             lambda: ops.fused_panel(X, 0, b=B, m_loc_pad=m, levels=L),
             lambda: ref.fused_panel(X, 0, b=B, m_loc_pad=m, levels=L))):
        err, scaled = max_err(as_tuple(run()), as_tuple(plain()))
        check(scaled <= tol, f"{name} at m = {m}: scaled error {scaled}")
        C = backend.team_blocks(m, B)
        out[name] = dict(shape=[P, m, w], max_abs_err=err, scaled_err=scaled,
                         team=C, slab_in_smem=backend.team_slab_in_smem(m, B, C),
                         ms=time_ms(run, 5))
    return out


def shrink_phase(A: torch.Tensor) -> None:
    """SHRINK after one death: the scheduled elastic sweep (stepped) and
    the same kill online (fused), R bit-equal between the two and the Gram
    identity within GRAM_TOL. With P = 8 and one death under the "pad"
    policy the new world keeps 8 slots and the adopter's slice doubles, so
    the next epoch runs at m_loc_pad = 2 M_LOC."""
    lane, point = 3, sweep_point(8, "trailing", L - 1)
    backend.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = ft_caqr_sweep(A, SimComm(P), B, semantics=Semantics.SHRINK,
                          schedule=FailureSchedule(events={point: [lane]}))
    torch.cuda.synchronize()
    sched_s = time.perf_counter() - t0
    PATH_LAUNCHES["shrink_scheduled"] = dict(backend.LAUNCHES)
    res, stats, launches = online_run(A, {point: [lane]}, fused=True,
                                      semantics=Semantics.SHRINK)
    PATH_LAUNCHES["shrink_online"] = launches
    same = torch.equal(sched.R, res.R)
    gram = gram_error(A.reshape(-1, N).double(), res.R)
    (t,) = res.transitions
    emit({"shrink": dict(
        killed=lane, point=list(point), scheduled_seconds=sched_s,
        online=stats, R_bitwise_scheduled_online=same,
        transitions_equal=sched.transitions == res.transitions,
        ledger_equal=ledger(sched.events) == ledger(res.events),
        frontier=t.frontier, adopter=t.adopter,
        world_after=dict(n_slots=t.world_after.n_slots,
                         live=list(t.world_after.live)),
        gram_rel_err=gram, launches_scheduled=PATH_LAUNCHES["shrink_scheduled"],
        launches_online=launches,
        shrunk_kernels=shrunk_kernel_check(A.device, 2 * M_LOC, N - 9 * B))})
    check(same, "SHRINK: online R differs from the scheduled R")
    check(sched.transitions == res.transitions and
          ledger(sched.events) == ledger(res.events),
          "SHRINK: transitions or ledgers differ")
    check(t.world_after.n_slots == P and t.world_after.n_live == P - 1,
          f"SHRINK world {t.world_after}")
    check(gram <= GRAM_TOL, f"SHRINK Gram identity: {gram} > {GRAM_TOL}")
    check(launches["fused_panel"] == N // B,
          f"SHRINK online K6 launches {launches}")


def spread_sweeps(A: torch.Tensor) -> dict:
    """The spread phase's full-width single-process sweeps by name."""
    comm = SimComm(P)
    kills = {pt: [lane] for pt, lane in KILLS.items()}
    ends = {pt: [lane] for pt, lane in PANEL_END_KILLS.items()}

    def fused():
        s = sm.initial_sweep_state(comm, A, B)
        while s.cursor is not None:
            s = sm.run_panel_fused(comm, s)
        return sm.finalize(comm, s)

    def online(k, **kw):
        return lambda: ft_caqr_sweep_online(
            A, comm, B, fault_hooks=[ScriptedKiller(k)], **kw)

    return {
        "caqr_factorize": lambda: caqr_factorize(
            A, comm, B, use_scan=False, collect_bundles=True),
        "state_machine_stepped": lambda: sm.finalize(
            comm, sm.run_steps(comm, sm.initial_sweep_state(comm, A, B))),
        "state_machine_fused": fused,
        "ft_sweep_four_kills": lambda: ft_caqr_sweep(
            A, comm, B, schedule=FailureSchedule(events=kills)),
        "online_stepped_four_kills": online(kills),
        "online_fused_four_kills": online(ends, fused=True),
        "online_async_four_kills": online(kills, async_segments=True),
    }


def spread_times(fn) -> dict:
    """``fn`` run SPREAD_RUNS times, each run ending in a synchronise:
    median and min-max seconds."""
    times = []
    for _ in range(SPREAD_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del res
    times.sort()
    return dict(median_s=times[len(times) // 2], min_s=times[0],
                max_s=times[-1], runs=times)


def spread_phase(A: torch.Tensor) -> None:
    """Run-to-run spread: every full-width sweep SPREAD_RUNS times."""
    out = {name: spread_times(fn) for name, fn in spread_sweeps(A).items()}
    emit({"spread": dict(shape=[P * M_LOC, N], runs=SPREAD_RUNS, **out)})


def recovery_phase(A: torch.Tensor) -> None:
    comm = SimComm(P)
    backend.reset_launches()
    fac = ft_tsqr(A[..., :B], comm)
    C = A[..., B:]
    clean = recovery.run_ft_trailing(C, fac, comm)
    faulty = recovery.run_ft_trailing(C, fac, comm, fail_at_level=1,
                                      failed_lane=3, A_stacked=C)
    torch.cuda.synchronize()
    same = torch.equal(clean, faulty)
    emit({"recovery": dict(panel=[P, M_LOC, B], trailing=list(C.shape),
                           killed_lane=3, after_level=1, bitwise_equal=same,
                           launches=dict(backend.LAUNCHES))})
    check(same, "recovered run differs from the clean run")


def square_phase(rng) -> None:
    """4096 x 4096 over P = 8 (m_loc = 512): the root walks lanes 0-7,
    consumed lanes and row_start clamping past lane 0 occur."""
    n = N
    m_loc = n // P
    A = block_row_layout(rng.standard_normal((n, n)).astype(np.float32), P)
    comm = SimComm(P)
    ref_res = caqr_factorize(A, comm, B, use_scan=False, collect_bundles=True)
    want = flat_result(ref_res)
    gram = gram_error(A.reshape(-1, n).double(), ref_res.R[0])
    check(gram <= GRAM_TOL, f"square Gram identity: {gram} > {GRAM_TOL}")
    boundaries = lockstep(A)
    k = 13                     # col0 = 1664: rooted at lane 3
    root = (k * B) // m_loc
    out = kill_check(A, comm, {sweep_point(k, "trailing", 1): root}, want)
    del out["ledger"]
    emit({"square": dict(shape=[n, n], m_loc=m_loc, gram_rel_err=gram,
                         boundaries_bitwise=boundaries, kill=out)})


def ragged_phase(rng) -> None:
    m_loc, n = 4000, 4000
    A_np = rng.standard_normal((P * m_loc, n)).astype(np.float32)
    A = block_row_layout(A_np, P)
    res = caqr_factorize(A, SimComm(P), B, use_scan=False)
    torch.cuda.synchronize()
    check(tuple(res.R.shape) == (P, n, n), f"ragged R shape {res.R.shape}")
    gram = gram_error(A.reshape(-1, n).double(), res.R[0])
    check(gram <= GRAM_TOL, f"ragged Gram identity: {gram} > {GRAM_TOL}")
    del res
    boundaries = lockstep(A)
    emit({"ragged": dict(m_loc=m_loc, n=n, b=B, gram_rel_err=gram,
                         fused_boundaries_bitwise=boundaries)})


def serve_traffic(seed: int) -> list:
    """The serve phase's (A, rhs) requests from ``seed`` (the launcher's
    ``make_requests``): half drawn for each bucket, interleaved."""
    rng = np.random.default_rng(seed)
    halves = [make_requests(rng, SERVE_REQUESTS // 2, B, P * m_loc, n - 2,
                            SERVE_LSTSQ_FRAC) for m_loc, n in SERVE_BUCKETS]
    return [req for pair in zip(*halves) for req in pair]


def serve_service() -> QRService:
    """The serve phase's service on its default device (the card)."""
    return QRService(SimComm(P), panel_width=B, buckets=SERVE_BUCKETS,
                     max_slots=SERVE_SLOTS)


def serve_run(reqs: list, kill: bool = False) -> dict:
    """The service under ``reqs``, one request submitted a tick (the
    launcher's ``--arrive-every 1``), a synchronise after every tick; with
    ``kill``, lane SERVE_KILL_LANE dies at tick SERVE_KILL_TICK. Launch
    counters at 0 before it."""
    svc = serve_service()
    pending = list(reqs)
    rids, ticks, at_kill = [], [], []
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    while pending or svc.queue or svc.resident:
        if pending:
            rids.append(svc.submit(*pending.pop(0)))
        if kill and svc.tick_count == SERVE_KILL_TICK:
            svc.kill_lane(SERVE_KILL_LANE)
            at_kill = [s.req.rid for s in svc.slots if s is not None]
        t = time.perf_counter()
        svc.tick()
        torch.cuda.synchronize()
        ticks.append(time.perf_counter() - t)
    wall = time.perf_counter() - t0
    return dict(results=svc.results, rids=rids, wall=wall, ticks=ticks,
                at_kill=at_kill, device=svc.device,
                launches=dict(backend.LAUNCHES))


def serve_checks(reqs: list, run: dict) -> dict:
    """Every tenant's R against the Gram identity of its own A and every
    lstsq x against the float64 solution, both on the service's device."""
    dev = run["device"]
    gram, lst = [], []
    for rid, (A, rhs) in zip(run["rids"], reqs):
        r = run["results"][rid]
        A64 = torch.from_numpy(A).to(dev).double()
        gram.append(gram_error(A64, torch.from_numpy(r.R).to(dev)))
        if rhs is not None:
            x_ref = torch.linalg.lstsq(
                A64, torch.from_numpy(rhs).to(dev).double()).solution
            x = torch.from_numpy(r.x).to(dev).double()
            lst.append(float((x - x_ref).norm() / x_ref.norm()))
        del A64
    check(max(gram) <= GRAM_TOL, f"serve Gram identity: {max(gram)} > {GRAM_TOL}")
    check(max(lst) <= LSTSQ_TOL, f"serve lstsq vs float64: {max(lst)} > {LSTSQ_TOL}")
    return dict(gram_rel_err_max=max(gram), lstsq_tenants=len(lst),
                lstsq_rel_err_max=max(lst))


def leading_rank(X: torch.Tensor, b: int) -> int:
    """How many leading columns of the first panel ``X[..., :b]`` of a
    (P, m_loc, n) block-row matrix are numerically independent on every
    lane: the columns before the first whose float64 pivot |R_jj| falls
    below DEPENDENT_PIVOT of the lane's largest."""
    d = torch.linalg.qr(X[..., :b].double(), mode="r").R.diagonal(
        dim1=-2, dim2=-1).abs()
    ok = d >= DEPENDENT_PIVOT * d.amax(-1, keepdim=True)
    return int(torch.cumprod(ok.int(), -1).sum(-1).min())


def determined(op: str, outs: tuple, rank: int) -> tuple:
    """The outputs of a panel QR (K1's Y, T, R; K3's Y2, T, R) that its
    first ``rank`` reflectors fix: a reflector past the rank of the columns
    before it is round-off in any QR, and so are the entries of Y and T
    that depend on it and the rows of R it makes. Other kernels' outputs
    are all fixed by their inputs."""
    if op not in ("panel_qr", "stacked_qr"):
        return outs
    Y, T, R = outs
    return Y[..., :rank], T[..., :rank, :rank], R[..., :rank, :]


def stepped_kernel_check(X: torch.Tensor, b: int, rs_last, worst: dict,
                         where: str, rank: int = 0) -> None:
    """K1-K4 against their plain versions on a (P, m_loc, n) block-row
    matrix ``X`` at panel width ``b``: K1 at row start 0 and at the last
    panel's row starts ``rs_last`` (one a lane), on P lanes and on one (the
    REBUILD replay); K2 on the first, a middle and the last panel's window
    and on one lane; K3 on a butterfly pair's R factors; K4 at the first
    and the last window. With ``0 < rank < b`` (the first panel's leading
    columns past ``rank`` depend on those before them), K1's and K3's
    outputs are held where the first ``rank`` reflectors fix them
    (``determined``). Raises past the tolerance; folds each kernel's
    largest scaled error into ``worst``."""
    tol = ref.tolerances(torch.float32)[0]
    P, _, n = X.shape
    pairs = [p ^ 1 for p in range(P)]
    panel = X[..., :b].contiguous()
    Y, T, R = ops.panel_qr(panel, 0)
    Y2, T2, _ = ops.stacked_qr(R, R[pairs].contiguous())
    cases = [("panel_qr", (panel, 0)), ("panel_qr", (panel, rs_last)),
             ("panel_qr", (panel[1], 0)),
             ("panel_qr", (panel[0], int(rs_last[0]))),
             ("wy_apply", (Y[1], T[1], X[1])),
             ("stacked_qr", (R, R[pairs].contiguous()))]
    cases += [("wy_apply", (Y, T, X[..., n - w:].contiguous()))
              for w in sorted({n, max(n // 2, 1), b})]
    for w in sorted({n, b}):
        Ct = X[:, :b, n - w:].contiguous()
        cases.append(("stacked_apply", (Y2, T2, Ct, Ct[pairs].contiguous())))
    r = rank if 0 < rank < b else b
    for op, args in cases:
        _, scaled = max_err(determined(op, as_tuple(getattr(ops, op)(*args)), r),
                            determined(op, as_tuple(getattr(ref, op)(*args)), r))
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        check(scaled <= tol, f"{where}: {op} at {shapes}: scaled error "
              f"{scaled} over {tol}")
        worst[op] = max(worst.get(op, 0.0), scaled)


def serve_kernel_check(reqs: list, run: dict) -> dict:
    """K1-K4 at each bucket's shapes against their plain versions
    (``stepped_kernel_check``), on two inputs a bucket: the first tenant of
    ``run`` that it served ([A | rhs] zero-padded into the bucket, as
    admission pads it), and seeded random data. Returns the largest scaled
    error of each kernel at each bucket."""
    g = torch.Generator().manual_seed(2)
    out = {}
    dev = run["device"]
    for m_loc, n_b in SERVE_BUCKETS:
        tenant = next(A if rhs is None else np.concatenate([A, rhs], axis=1)
                      for rid, (A, rhs) in zip(run["rids"], reqs)
                      if run["results"][rid].bucket == (m_loc, n_b))
        n_last = sweep_geometry(P, m_loc, n_b, B).n_panels - 1
        rs_last = panel_geometry(SimComm(P), n_last, B, m_loc)[2]
        worst = {}
        for X in (block_row_layout(tenant, P, m_loc, n_b, device=dev),
                  torch.randn(P, m_loc, n_b, generator=g).to(dev)):
            stepped_kernel_check(X, B, rs_last, worst,
                                 f"serve bucket {(m_loc, n_b)}")
            del X
        out[str([m_loc, n_b])] = dict(
            team=backend.team_blocks(m_loc, B),
            last_row_start=int(rs_last[0]), scaled_err_max=worst)
    return out


def serve_same(got: dict, want: dict) -> bool:
    """Every tenant's R and x in ``got`` bit-equal to ``want``'s."""
    return all(np.array_equal(got[rid].R, r.R) and
               (r.x is None) == (got[rid].x is None) and
               (r.x is None or np.array_equal(got[rid].x, r.x))
               for rid, r in want.items())


def serve_stats(run: dict) -> dict:
    lat = sorted(r.latency_s for r in run["results"].values())
    ticks = sorted(run["ticks"])
    n = len(run["results"])
    return dict(requests=n, seconds=run["wall"], req_per_s=n / run["wall"],
                p50_latency_s=lat[n // 2],
                p99_latency_s=lat[min(n - 1, int(n * 0.99))],
                ticks=len(ticks), tick_seconds_median=ticks[len(ticks) // 2],
                tick_seconds_max=ticks[-1], launches=run["launches"])


def serve_phase(seed: int, card: str) -> None:
    """The QR service at full width: failure-free, with a lane killed
    mid-batch, and drain_batched, on the same traffic (see the module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    reqs = serve_traffic(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    clean = serve_run(reqs)
    PATH_LAUNCHES["serve"] = clean["launches"]
    checks = serve_checks(reqs, clean)
    want = clean["results"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = serve_run(reqs)
    by_kernel, other = device_time_by_kernel(prof)
    # the copies and fills inside "other" (admission's host-to-device copy)
    copies = {e.key: _device_us(e) / 1e3 for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.key.startswith(("Memcpy", "Memset"))}
    compute = sum(by_kernel.values()) + other - sum(copies.values())
    # both shares over the profiled drain's own wall time (the tracer
    # slows the host, so it is longer than the first drain's)
    prof_ms = profiled["wall"] * 1e3
    profiled_same = serve_same(profiled["results"], want)
    del prof, profiled
    killed = serve_run(reqs, kill=True)
    PATH_LAUNCHES["serve_kill"] = killed["launches"]
    kill_same = serve_same(killed["results"], want)
    healed = {rid: killed["results"][rid].events for rid in killed["at_kill"]}
    heal_s = sorted(sum(e.elapsed_s for e in ev) for ev in healed.values())
    svc = serve_service()
    drained = {}
    torch.cuda.synchronize()
    backend.reset_launches()
    t0 = time.perf_counter()
    for i in range(0, len(reqs), SERVE_GROUP):
        for A, rhs in reqs[i:i + SERVE_GROUP]:
            svc.submit(A, rhs)
        drained.update(svc.drain_batched())
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    PATH_LAUNCHES["serve_batched"] = dict(backend.LAUNCHES)
    drain_same = serve_same(drained, want)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    kernels = serve_kernel_check(reqs, clean)
    emit({"serve": dict(
        P=P, b=B, buckets=[list(bk) for bk in SERVE_BUCKETS],
        slots=SERVE_SLOTS, requests=len(reqs),
        lstsq_requests=sum(rhs is not None for _, rhs in reqs),
        buckets_used={str(list(bk)): sum(r.bucket == bk for r in want.values())
                      for bk in SERVE_BUCKETS},
        largest=max(list(A.shape) for A, _ in reqs),
        failure_free=serve_stats(clean), **checks,
        profiled_wall_ms=prof_ms, compute_busy_share=compute / prof_ms,
        copy_share=sum(copies.values()) / prof_ms,
        profiled_kernel_ms=by_kernel,
        profiled_other_compute_ms=other - sum(copies.values()),
        profiled_copy_ms=copies,
        kill=dict(lane=SERVE_KILL_LANE, tick=SERVE_KILL_TICK,
                  **serve_stats(killed), resident_at_kill=len(healed),
                  heal_seconds_per_tenant=heal_s,
                  events=sum(len(ev) for ev in healed.values()),
                  bitwise_equal_failure_free=kill_same),
        batched=dict(seconds=drain_s, group=SERVE_GROUP,
                     req_per_s=len(drained) / drain_s,
                     launches=PATH_LAUNCHES["serve_batched"],
                     bitwise_equal_continuous=drain_same),
        bucket_kernels=kernels, peak_mem_gb_above_live=peak,
        phase_seconds=time.perf_counter() - t_phase, card=card)})
    check(profiled_same, "the profiled serve run differs from the first")
    check(kill_same, "serve: a tenant's R or x differs after the kill")
    # single source: each artifact is read from one surviving lane
    check(bool(healed) and all(
        len(ev) >= 1 and all(e.lane == SERVE_KILL_LANE and e.reads and
                             SERVE_KILL_LANE not in e.reads.values()
                             for e in ev)
        for ev in healed.values()),
          "serve: a tenant resident at the kill has no single-source event")
    check(drain_same, "serve: drain_batched differs from continuous batching")
    for path in ("serve", "serve_kill", "serve_batched"):
        check(all(PATH_LAUNCHES[path][op] > 0 for op in STEPPED),
              f"{path}: K1-K4 not all launched: {PATH_LAUNCHES[path]}")


def train_configs(seed: int):
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=seed)
    return cfg, dcfg


def train_tcfg(ckpt_dir: str, **kw) -> TrainConfig:
    base = dict(steps=TRAIN_STEPS, lr=TRAIN_LR, warmup=TRAIN_WARMUP,
                n_lanes=TRAIN_LANES, diskless_every=2, log_every=10 ** 9,
                optimizer="caqr_muon", ckpt_dir=ckpt_dir)
    base.update(kw)
    return TrainConfig(**base)


def train_fcfg(**kw) -> FTRunConfig:
    return FTRunConfig(qr_lanes=TRAIN_LANES, panel_width=TRAIN_B, **kw)


def same_tree(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


def train_run(tr, path: str = "", schedule=None, gram: bool = False,
              watch: str = "") -> dict:
    """Run trainer ``tr`` to its end: its history, step and phase seconds,
    the engine's stats, peak memory (above what was live before it, and in
    all), and with ``path`` the launches counted from 0 just before the
    run; with ``gram`` every sweep's R held to the Gram identity of its
    momentum slice (float64, on the card), and the column norms of the Q
    that the sweeps of task ``watch`` give (``A R^-1``, as the engine forms
    it)."""
    grams, watched = [], []
    if gram:
        factorize = tr.engine.factorize

        def checked(M, resume_state=None):
            R = factorize(M, resume_state=resume_state)
            grams.append((tr._cur_step, tr._cur_task,
                          gram_error(M.double(), R)))
            if tr._cur_task == watch:
                Q = torch.linalg.solve_triangular(R, M, upper=True, left=False)
                watched.append(Q.norm(dim=0).tolist())
            return R

        tr.engine.factorize = checked
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    backend.reset_launches()
    t0 = time.perf_counter()
    hist = tr.run(schedule)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if path:
        PATH_LAUNCHES[path] = dict(backend.LAUNCHES)
    dts = [h["dt"] for h in hist]
    out = dict(wall_seconds=wall, losses=[h["loss"] for h in hist],
               steps=[h["step"] for h in hist], step_seconds=dts,
               step_seconds_median=sorted(dts)[len(dts) // 2],
               peak_mem_gb_above_live=(torch.cuda.max_memory_allocated() - base) / 1e9,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=dict(backend.LAUNCHES))
    if isinstance(tr, FTTrainer):
        e = tr.engine
        out.update(phase_seconds=dict(tr.phase_s), sweeps=e.sweeps,
                   boundaries=e.boundaries, segments=e.segments,
                   engine_sweep_seconds=e.sweep_s, poll_seconds=e.poll_s,
                   heal_seconds=e.recover_s, events=len(e.events))
    if gram:
        out["gram"] = grams
    if watch:
        out["watch"] = watched
    return out


def train_kernel_check(mom, tasks: list, g: torch.Generator,
                       shapes=TRAIN_SHAPES) -> dict:
    """K1-K4 at a train path's shapes ((m_loc, n, b), TRAIN_SHAPES by
    default) against their plain versions, on 4 lanes and on one
    (``stepped_kernel_check``): the Muon shapes on a momentum slice of the
    failure-free run laid out as the engine lays it out, and on random
    data; the projection shapes on random data."""
    dev = tree.leaves(mom)[0].device
    by_shape = {}
    for task in tasks:
        M = task_slice(mom, task)
        A = (M.T if task.transpose else M).float()
        by_shape.setdefault((A.shape[0] // TRAIN_LANES, A.shape[1]), A)
    out = {}
    for m_loc, n, b in shapes:
        geom = sweep_geometry(TRAIN_LANES, m_loc, n, b)
        rs_last = panel_geometry(SimComm(TRAIN_LANES), geom.n_panels - 1, b,
                                 m_loc)[2]
        inputs = [torch.randn(TRAIN_LANES, m_loc, n, generator=g).to(dev)]
        if (m_loc, n) in by_shape:
            inputs.append(by_shape[(m_loc, n)].reshape(TRAIN_LANES, m_loc, n)
                          .contiguous())
        worst, ranks = {}, []
        for X in inputs:
            ranks.append(leading_rank(X, b))
            stepped_kernel_check(X, b, rs_last, worst,
                                 f"train shape {(TRAIN_LANES, m_loc, n)} b={b}",
                                 rank=ranks[-1])
        out[str([TRAIN_LANES, m_loc, n, b])] = dict(
            team=backend.team_blocks(m_loc, b), inputs=len(inputs),
            leading_rank=ranks, last_row_start=int(rs_last[0]),
            scaled_err_max=worst)
    return out


def train_profile(cfg, dcfg, d: str, clean: dict) -> dict:
    """Device time by kernel over one more failure-free step under
    torch.profiler, against the failure-free run's unprofiled step and
    task-loop seconds (past the first step's warm-up): how much of the
    step the card is busy, and how much of the task loop K1-K4 fill. The
    diskless push's device-to-host copy is counted apart."""
    from torch.profiler import ProfilerActivity, profile

    tr = FTTrainer(cfg, train_tcfg(d, steps=1), dcfg, train_fcfg())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tr.run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, other = device_time_by_kernel(prof)
    copies = sum(_device_us(e) / 1e3 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.key.startswith(("Memcpy", "Memset")))
    steps = sorted(clean["step_seconds"][1:])
    step_ms = 1e3 * steps[len(steps) // 2]
    tasks_ms = 1e3 * clean["phase_seconds"]["tasks"] / TRAIN_STEPS
    kernels = sum(by_kernel.values())
    return dict(profiled_wall_ms=wall_ms, kernel_ms=by_kernel,
                other_compute_ms=other - copies, copy_ms=copies,
                step_ms_median=step_ms, task_loop_ms_per_step=tasks_ms,
                compute_busy_share=(kernels + other - copies) / step_ms,
                k1_k4_share_of_task_loop=kernels / tasks_ms)


@contextlib.contextmanager
def deterministic_mode():
    """torch's deterministic mode for a training phase, restored after it:
    deterministic scatter-adds for the embedding's and the CE pick's
    backward (and the MoE dispatch's and combine's); every kernel writes all
    of its outputs, so the fill of fresh memory the mode also turns on (a
    debugging aid) stays off."""
    det_before = torch.are_deterministic_algorithms_enabled()
    fill_before = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(det_before)
        torch.utils.deterministic.fill_uninitialized_memory = fill_before


def train_phase(seed: int, card: str) -> None:
    """The FT training runtime at TinyLlama's full width (see the module
    docstring), under torch's deterministic mode."""
    t_phase = time.perf_counter()
    with deterministic_mode(), tempfile.TemporaryDirectory() as d:
        report = train_runs(seed, d, card)
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit({"train": report})


def train_runs(seed: int, d: str, card: str) -> dict:
    cfg, dcfg = train_configs(seed)
    muon = lambda **kw: FTTrainer(cfg, train_tcfg(d), dcfg, train_fcfg(**kw))  # noqa: E731
    # 1. failure-free, twice: the determinism check
    ref = muon()
    clean = train_run(ref, "train", gram=True)
    grams = clean.pop("gram")
    tasks = ref._tasks
    want_params, want_opt = ref.state.params, ref.state.opt_state
    kernels = train_kernel_check(want_opt.mom, tasks,
                                 torch.Generator().manual_seed(seed + 3))
    del ref
    profiled = train_profile(cfg, dcfg, d, clean)
    again = muon()
    second = train_run(again)
    det_same = (same_tree(again.state.params, want_params)
                and same_tree(again.state.opt_state, want_opt)
                and second["losses"] == clean["losses"])
    del again, want_opt
    check(det_same, "train: two failure-free runs differ")
    bps = clean["boundaries"] // TRAIN_STEPS
    # 2. a lane killed mid-sweep inside step 2
    killer = StepSweepKiller(**TRAIN_KILL)
    tr = FTTrainer(cfg, train_tcfg(d), dcfg, train_fcfg(), qr_fault_hooks=[killer])
    kill = train_run(tr, "train_kill")
    ev = tr.engine.events
    kill_same = same_tree(tr.state.params, want_params) and \
        kill["losses"] == clean["losses"]
    kill.update(struck=killer.struck,
                event_reads=[{str(k): int(v) for k, v in e.reads.items()} for e in ev])
    del tr
    # 3. async double-buffered segments, the same kill
    killer_a = StepSweepKiller(**TRAIN_KILL)
    tr = FTTrainer(cfg, train_tcfg(d), dcfg, train_fcfg(async_segments=True),
                   qr_fault_hooks=[killer_a])
    asyn = train_run(tr)
    async_same = same_tree(tr.state.params, want_params) and killer_a.fired
    del tr
    # 4. suspended inside step 2, resumed from disk in this process
    n_suspend = 2 * bps + bps // 2
    tr = muon(suspend_after_boundaries=n_suspend)
    t0 = time.perf_counter()
    try:
        tr.run()
        suspended = None
    except TrainingSuspended as exc:
        suspended = exc
    suspend_s = time.perf_counter() - t0
    del tr
    check(suspended is not None and suspended.step == 2,
          f"train: no suspension inside step 2 ({suspended})")
    t0 = time.perf_counter()
    resumed = FTTrainer.resume(cfg, train_tcfg(d), dcfg, train_fcfg())
    restore_s = time.perf_counter() - t0
    res = train_run(resumed)
    resume_same = same_tree(resumed.state.params, want_params)
    res.update(suspended_at=dict(boundary=n_suspend, step=suspended.step,
                                 task=suspended.task),
               suspend_run_seconds=suspend_s, restore_seconds=restore_s)
    del resumed
    # 5. a training-level lane death at step 3: diskless restore and replay
    tr = muon()
    rebuild = train_run(tr, schedule=FailureSchedule(events=TRAIN_FAIL))
    rebuild_same = same_tree(tr.state.params, want_params)
    del tr
    # 6. the PowerSGD bridge, failure-free and with a kill in its sweep
    psgd = lambda hooks=(): FTTrainer(  # noqa: E731
        cfg, train_tcfg(d, optimizer="adamw", steps=TRAIN_PSGD_STEPS), dcfg,
        train_fcfg(compression_rank=TRAIN_PSGD_RANK), qr_fault_hooks=hooks)
    p_ref = psgd()
    p_clean = train_run(p_ref, "train_psgd")
    p_tasks = len(p_ref._tasks)
    p_killer = StepSweepKiller(at_step=1, lane=2)
    p_tr = psgd([p_killer])
    p_kill = train_run(p_tr)
    psgd_same = (same_tree(p_tr.state.params, p_ref.state.params)
                 and p_kill["losses"] == p_clean["losses"] and p_killer.fired)
    p_kill["struck"] = p_killer.struck
    del p_ref, p_tr
    # 7. the plain trainer (adamw), no QR
    plain = train_run(Trainer(cfg, train_tcfg(d, optimizer="adamw"), dcfg))
    del want_params
    launches_ok = {path: all(PATH_LAUNCHES[path][op] > 0 for op in STEPPED)
                   and PATH_LAUNCHES[path]["panel_qr_apply"] == 0
                   and PATH_LAUNCHES[path]["fused_panel"] == 0
                   for path in ("train", "train_kill", "train_psgd")}
    gram_max = max(g for *_, g in grams)
    report = dict(
        arch=TRAIN_ARCH, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hdim, d_ff=cfg.d_ff,
        vocab=cfg.vocab, dtype=cfg.dtype, n_layers=cfg.n_layers,
        seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, data_lanes=TRAIN_LANES,
        steps=TRAIN_STEPS, qr_lanes=TRAIN_LANES, panel_width=TRAIN_B,
        reduced=TRAIN_REDUCED, tasks_per_step=len(tasks),
        deterministic="torch.use_deterministic_algorithms(True), "
                      "CUBLAS_WORKSPACE_CONFIG=" + os.environ["CUBLAS_WORKSPACE_CONFIG"],
        failure_free=clean, second_bitwise_equal=det_same,
        profiled_step=profiled,
        gram_checked=len(grams), gram_rel_err_max=gram_max,
        kill=dict(**kill, bitwise_equal_failure_free=kill_same),
        async_segments=dict(**asyn, bitwise_equal_failure_free=async_same),
        suspend_resume=dict(**res, bitwise_equal_failure_free=resume_same),
        rebuild=dict(**rebuild, fail=TRAIN_FAIL,
                     bitwise_equal_failure_free=rebuild_same),
        psgd=dict(rank=TRAIN_PSGD_RANK, tasks_per_step=p_tasks,
                  failure_free=p_clean, kill=p_kill,
                  bitwise_equal_failure_free=psgd_same),
        plain_adamw=plain, kernels=kernels, launches_ok=launches_ok,
        card=card)
    losses = clean["losses"]
    check(all(np.isfinite(x) for x in losses), f"train: a loss is not finite {losses}")
    check(losses[-1] < losses[0], f"train: the loss did not fall {losses}")
    check(gram_max <= GRAM_TOL, f"train Gram identity: {gram_max} > {GRAM_TOL}")
    check(len({s for s, *_ in grams}) == TRAIN_STEPS,
          "train: a step without a Gram-checked sweep")
    check(kill_same, "train: the mid-sweep kill changed params or losses")
    check(killer.struck is not None and killer.struck[:2] == (
        TRAIN_KILL["at_step"], TRAIN_KILL["task"]), f"train: kill struck {killer.struck}")
    check(len(ev) == 1 and ev[0].lane == TRAIN_KILL["lane"] and ev[0].reads
          and TRAIN_KILL["lane"] not in ev[0].reads.values(),
          f"train: not one single-source REBUILD event: {ev}")
    check(kill["steps"] == list(range(TRAIN_STEPS)),
          f"train: the kill rewound training: steps {kill['steps']}")
    check(async_same, "train: async segments differ from sync")
    check(resume_same, "train: suspend/resume differs from the uninterrupted run")
    check(rebuild_same and rebuild["steps"] == [0, 1, 2, 2, 3],
          f"train: the REBUILD replay differs (steps {rebuild['steps']})")
    check(psgd_same, "train: the PowerSGD-bridge kill differs from failure-free")
    check(all(launches_ok.values()), f"train: launches {launches_ok}")
    return report


def moe_configs(seed: int):
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=MOE_SEQ,
                      global_batch=MOE_BATCH, seed=seed)
    return cfg, dcfg


class RoutingCount:
    """Counts the token assignments that the MoE layers route, and those
    dropped at capacity, while it is entered (it wraps
    ``models.moe.route``; the forward that the backward's checkpoint
    recomputes counts again, which leaves the share as it is)."""

    def __enter__(self):
        self.dropped, self.total = [], 0
        self._route = t_moe.route

        def counted(probs, top_k, capacity_factor):
            r, ids = self._route(probs, top_k, capacity_factor)
            self.dropped.append((~r.keep).sum())
            self.total += r.keep.numel()
            return r, ids

        t_moe.route = counted
        return self

    def __exit__(self, *exc):
        t_moe.route = self._route

    def share(self) -> float:
        return float(torch.stack(self.dropped).sum()) / self.total


def tree_digest(t) -> list:
    """One int64 a tensor leaf: its bits read as integers, weighted by
    their position and summed (wrapping) in chunks on the leaf's device. Two
    trees with the same bits give the same digests; no second copy of the
    tree is made."""
    out, chunk = [], 1 << 26
    for leaf in tree.leaves(t):
        flat = leaf.reshape(-1)
        bits = flat.view({2: torch.int16, 4: torch.int32}[flat.element_size()])
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for i in range(0, bits.numel(), chunk):
            c = bits[i:i + chunk].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device) % 1000003 + 1
            acc += torch.sum(c * w)
        out.append(int(acc))
    return out


def same_as_host(t, host) -> bool:
    """Every leaf of tree ``t`` bit-equal to ``host``'s (a host copy)."""
    return all(torch.equal(x.cpu(), y)
               for x, y in zip(tree.leaves(t), tree.leaves(host)))


def moe_phase(seed: int, card: str) -> None:
    """The FT training runtime on mixtral-8x22b at its published width (see
    the module docstring), under torch's deterministic mode."""
    t_phase = time.perf_counter()
    # what earlier phases left in reference cycles goes before the trainers
    gc.collect()
    torch.cuda.empty_cache()
    with deterministic_mode(), tempfile.TemporaryDirectory() as d:
        report = moe_runs(seed, d, card)
    report["phase_seconds"] = time.perf_counter() - t_phase
    emit({"train_moe": report})


def moe_runs(seed: int, d: str, card: str) -> dict:
    cfg, dcfg = moe_configs(seed)
    # the loop pushes its diskless checkpoint at step 0 whatever the period;
    # a period past the last step pushes no other
    tcfg = train_tcfg(d, steps=MOE_STEPS, diskless_every=MOE_STEPS + 1)
    make = lambda hooks=(): FTTrainer(  # noqa: E731
        cfg, tcfg, dcfg, train_fcfg(), qr_fault_hooks=hooks)
    # two trainers do not fit on the card together: each run's trainer is
    # dropped (and its reference cycles collected: hooks and the Gram
    # check hold the trainer) before the next, keeping a host copy of the
    # first run's params and a digest of its optimizer state
    # 1. failure-free, every sweep's R held to the Gram identity
    tr = make()
    tasks = tr._tasks
    shapes = sorted({(t.rows, t.cols) for t in tasks}, reverse=True)
    with RoutingCount() as routed:
        clean = train_run(tr, "train_moe", gram=True, watch=MOE_ROUTER)
    grams, router_q = clean.pop("gram"), clean.pop("watch")
    want_params = tree.map(lambda x: x.cpu(), tr.state.params)
    want_opt = tree_digest(tr.state.opt_state)
    kernels = train_kernel_check(tr.state.opt_state.mom, tasks,
                                 torch.Generator().manual_seed(seed + 5),
                                 MOE_SHAPES)
    del tr
    gc.collect()
    # 2. failure-free again: the determinism check (and the step seconds
    # without the Gram checks)
    tr = make()
    second = train_run(tr)
    det_same = (same_as_host(tr.state.params, want_params)
                and tree_digest(tr.state.opt_state) == want_opt
                and second["losses"] == clean["losses"])
    del tr
    gc.collect()
    check(det_same, "train_moe: two failure-free runs differ")
    # 3. lane 1 killed mid-sweep inside an expert bank's sweep of step 2
    killer = StepSweepKiller(**MOE_KILL)
    tr = make([killer])
    kill = train_run(tr, "train_moe_kill")
    ev = tr.engine.events
    kill_same = (same_as_host(tr.state.params, want_params)
                 and kill["losses"] == clean["losses"])
    kill_opt_same = tree_digest(tr.state.opt_state) == want_opt
    kill.update(struck=killer.struck,
                event_reads=[{str(k): int(v) for k, v in e.reads.items()} for e in ev])
    del tr, want_params
    gc.collect()
    launches_ok = {path: all(PATH_LAUNCHES[path][op] > 0 for op in STEPPED)
                   and PATH_LAUNCHES[path]["panel_qr_apply"] == 0
                   and PATH_LAUNCHES[path]["fused_panel"] == 0
                   for path in ("train_moe", "train_moe_kill")}
    gram_max = max(g for *_, g in grams)
    m = cfg.moe
    N = MOE_BATCH * MOE_SEQ
    report = dict(
        arch=MOE_ARCH, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hdim, n_experts=m.n_experts,
        top_k=m.top_k, d_ff_expert=m.d_ff_expert, vocab=cfg.vocab,
        sliding_window=cfg.sliding_window, rope_theta=cfg.rope_theta,
        dtype=cfg.dtype, n_layers=cfg.n_layers, seq_len=MOE_SEQ,
        global_batch=MOE_BATCH, data_lanes=TRAIN_LANES, steps=MOE_STEPS,
        qr_lanes=TRAIN_LANES, panel_width=TRAIN_B, reduced=MOE_REDUCED,
        tasks_per_step=len(tasks), sweep_shapes=shapes,
        capacity=t_moe.capacity(N, m.top_k, m.n_experts, m.capacity_factor),
        dropped_share=routed.share(),
        deterministic="torch.use_deterministic_algorithms(True), "
                      "CUBLAS_WORKSPACE_CONFIG=" + os.environ["CUBLAS_WORKSPACE_CONFIG"],
        failure_free=clean, second=second, second_bitwise_equal=det_same,
        gram_checked=len(grams), gram_rel_err_max=gram_max,
        router_q_column_norms=router_q,
        kill=dict(**kill, bitwise_equal_failure_free=kill_same,
                  opt_state_equal_failure_free=kill_opt_same),
        kernels=kernels, launches_ok=launches_ok, card=card)
    losses = clean["losses"]
    check(all(np.isfinite(x) for x in losses), f"train_moe: a loss is not finite {losses}")
    check(len(tasks) == MOE_SWEEPS,
          f"train_moe: {len(tasks)} sweeps a step, not {MOE_SWEEPS}")
    check(gram_max <= GRAM_TOL, f"train_moe Gram identity: {gram_max} > {GRAM_TOL}")
    check(len(grams) == MOE_STEPS * len(tasks),
          f"train_moe: {len(grams)} Gram-checked sweeps")
    check(kill_same and kill_opt_same,
          "train_moe: the mid-sweep kill changed params, optimizer state or losses")
    check(killer.struck is not None and killer.struck[:2] == (
        MOE_KILL["at_step"], MOE_KILL["task"]), f"train_moe: kill struck {killer.struck}")
    check(len(ev) == 1 and ev[0].lane == MOE_KILL["lane"] and ev[0].reads
          and MOE_KILL["lane"] not in ev[0].reads.values(),
          f"train_moe: not one single-source REBUILD event: {ev}")
    check(kill["steps"] == list(range(MOE_STEPS)),
          f"train_moe: the kill rewound training: steps {kill['steps']}")
    check(all(launches_ok.values()), f"train_moe: launches {launches_ok}")
    return report


def wide_record(op: str, args: tuple, cost: tuple, lib, reps: int) -> dict:
    """One kernel above 128 columns against its plain version (within the
    tolerance, scaled as ``max_err`` scales it): events' time, device time
    (every kernel of the blocked route, glue included), bound, plain time
    (one call) and the library call's time."""
    run = lambda: getattr(ops, op)(*args)  # noqa: E731
    composed = COMPOSED.get(op)
    with OrderOracle() as oracle:
        got = as_tuple(run())
        one = composed is not None and same_bits(got, composed(*args))
    check(composed is None or one,
          f"wide {op}: the one launch differs from the composed route")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = as_tuple(getattr(ref, op)(*args))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, scaled = max_err(got, want)
    del got, want
    tol = ref.tolerances(torch.float32)[0]
    shapes = [list(a.shape) for a in args if torch.is_tensor(a)]
    check(scaled <= tol, f"wide {op} at {shapes}: scaled error {scaled} over {tol}")
    bms, by = bound_ms(*cost)
    rs = args[1] if op == "panel_qr" else None
    source, replaces = KERNELS[op]
    rec = dict(name=op, route="cuda", source=source,
               blocked_route="src/repro_torch/kernels/wide.py",
               replaces=replaces, shapes=shapes,
               row_start=rs.tolist() if torch.is_tensor(rs) else rs,
               products_held_to_oracle=oracle.summary(),
               max_abs_err=err, scaled_err=scaled, tolerance=tol,
               ms=time_ms(run, reps), device_ms=device_ms(run, reps),
               bound_ms=bms, bound_by=by, plain_ms=plain_ms,
               library_ms=time_ms(lib, reps),
               library_device_ms=device_ms(lib, reps))
    if composed is not None:
        # K1's one wide launch (K3: on the stacks) beside the composed route
        m, b = args[0].shape[-2:]
        P = args[0].shape[0] if args[0].dim() == 3 else 1
        cluster, grid = tpq.wide_launch_shape(
            P, 2 * b if op == "stacked_qr" else m, b)
        rec.update(source=WIDE_K1_SOURCE, cluster=cluster, grid=grid,
                   ptxas={**ptxas(WIDE_K1_SOURCE, "panel_qr_wide_kernel"),
                          **ptxas(WIDE_K1_SOURCE, "panel_qr_wide_global_kernel")},
                   equals_composed=one,
                   composed_ms=time_ms(lambda: composed(*args), reps),
                   composed_device_ms=device_ms(lambda: composed(*args), reps))
    return rec


def wide_kernels(A: torch.Tensor, g: torch.Generator) -> tuple:
    """K1-K4 at b = 256 on the tall cell's first panel and at the Muon
    path's K1 shapes, against their plain versions and timed; the bitwise
    contracts at b = 256. Returns (records, contracts)."""
    b, dev, f = WIDE_B, A.device, 4.0
    panel = A[..., :b].contiguous()
    k_last = N // b - 1
    rs_last = panel_geometry(SimComm(P), k_last, b, M_LOC)[2]
    recs = [wide_record("panel_qr", (panel, 0), leaf_cost(P, M_LOC, b, 0),
                        lambda: torch.geqrf(panel), 5)]
    rs0 = int(rs_last[0])
    # the last panel: lane 0 from row rs0, the others from row 0
    late = [leaf_cost(1, M_LOC, b, int(r)) for r in rs_last]
    recs.append(wide_record(
        "panel_qr", (panel, rs_last), tuple(map(sum, zip(*late))),
        lambda: (torch.geqrf(panel[1:]), torch.geqrf(panel[0, rs0:])), 10))
    for name, (m, bb) in MUON_K1.items():
        X = torch.randn(m, bb, generator=g).to(dev)
        rec = wide_record("panel_qr", (X, 0), leaf_cost(1, m, bb, 0),
                          lambda: torch.geqrf(X), 3 if bb > 1024 else 10)
        recs.append(dict(rec, muon_matrix=name))
        del X
    X = torch.randn(1000, 200, generator=g).to(dev)
    recs.append(wide_record("panel_qr", (X, 37), leaf_cost(1, 1000, 200, 37),
                            lambda: torch.geqrf(X[37:]), 10))
    Y, T, R = ops.panel_qr(panel, 0)
    Tr = (torch.randn(P, b, b, generator=g) / 16).triu().to(dev)
    for T_, which in ((T, "T of Y"), (Tr, "random upper-triangular T")):
        rec = wide_record("wy_apply", (Y, T_, A), wy_cost(P, M_LOC, b, N),
                          lambda: wy_library(Y, T_, A), 5)
        recs.append(dict(rec, t_factor=which))
    pairs = [p ^ 1 for p in range(P)]
    R_bot = R[pairs].contiguous()
    stack = torch.cat([R, R_bot], dim=1)
    recs.append(wide_record("stacked_qr", (R, R_bot),
                            (P * float(b ** 3), f * P * 5 * b * b),
                            lambda: torch.geqrf(stack), 10))
    Y2, T2, _ = ops.stacked_qr(R, R_bot)
    Ct = ops.wy_apply(Y, T, A)[:, :b].contiguous()
    Cb = Ct[pairs].contiguous()
    rec = wide_record("stacked_apply", (Y2, Tr, Ct, Cb), sa_cost(P, b, N),
                      lambda: sa_library(Y2, Tr, Ct, Cb), 10)
    recs.append(dict(rec, t_factor="random upper-triangular T"))
    # the bitwise contracts at b = 256
    k = P - 3
    one_k1 = same_bits(tuple(x[k] for x in ops.panel_qr(panel, rs_last)),
                       ops.panel_qr(panel[k], int(rs_last[k])))
    one_k2 = torch.equal(ops.wy_apply(Y, Tr, A)[k], ops.wy_apply(Y[k], Tr[k], A[k]))
    one_k4 = all(torch.equal(a[k], o) for a, o in zip(
        ops.stacked_apply(Y2, Tr, Ct, Cb), ops.stacked_apply(Y2[k], Tr[k], Ct[k], Cb[k])))
    pair = ops.stacked_qr(R[[p & ~1 for p in range(P)]].contiguous(),
                          R[[p | 1 for p in range(P)]].contiguous())
    pair_k3 = all(torch.equal(x[p], x[p ^ 1]) for x in pair for p in range(P))
    bn_k2 = same_bits(twy.wy_apply(Y, Tr, A, bn=32), twy.wy_apply(Y, Tr, A, bn=128))
    bn_k4 = same_bits(tsa.stacked_apply(Y2, Tr, Ct, Cb, bn=32),
                      tsa.stacked_apply(Y2, Tr, Ct, Cb, bn=128))
    contracts = dict(one_lane_k1=one_k1, one_lane_k2=one_k2, one_lane_k4=one_k4,
                     pair_k3=pair_k3, bn_k2=bn_k2, bn_k4=bn_k4)
    check(all(contracts.values()), f"wide: bitwise contracts {contracts}")
    # K5 and K6 at b = 256: one launch each, bit-equal to the stepped wide
    # route, timed beside their plain versions and the stepped route
    C = ops.wy_apply(Y, T, A)
    contracts["k5_equals_k1_k2"] = same_bits(ops.panel_qr_apply(A, 0, b),
                                             (Y, T, R, C, C[:, :b]))
    check(contracts["k5_equals_k1_k2"], "wide: K5 differs from K1 then K2")
    del C
    recs += fused_wide_records(A)
    return recs, contracts


# the composed routes of K1 and K3 above 128 columns (separate launches of
# K1's team kernel and wide_gemm): the bit oracle and time yardstick of
# K1's one wide launch
COMPOSED = {"panel_qr": tpq.panel_qr_composed,
            "stacked_qr": tsa.stacked_qr_composed}
WIDE_K1_SOURCE = "src/repro_torch/csrc/panel_qr_wide.cu"


class OrderOracle:
    """Holds every ``wide.gemm`` call inside it to the oracle of the
    summation order (``wide.gemm_order``) and to K5/K6's in-block
    instantiation (``fused_sweep.gemm_in_block``) on the same operands, bit
    for bit; the calls run unchanged."""

    def __init__(self):
        self.shapes = {}

    def __enter__(self):
        self.gemm = wide.gemm

        def checked(A, B, D=None, *, sub=False, out=None, bn=None,
                    minuend=None, kbs=None):
            res = self.gemm(A, B, D, sub=sub, out=out, bn=bn, minuend=minuend,
                            kbs=kbs)
            kw = dict(sub=sub, minuend=minuend)
            want = as_tuple(wide.gemm_order(A, B, D, **kw))
            fused = as_tuple(tfs.gemm_in_block(A, B, D, **kw))
            key = str([list(A.shape), list(B.shape), D is not None, sub,
                       minuend is not None])
            check(same_bits(res, want) and same_bits(fused, want),
                  f"wide_gemm or the in-block routine differs from the order "
                  f"oracle at {key}")
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return res

        wide.gemm = checked
        return self

    def __exit__(self, *exc):
        wide.gemm = self.gemm

    def summary(self) -> dict:
        return dict(products=sum(self.shapes.values()), shapes=len(self.shapes))


def fused_wide_records(A: torch.Tensor) -> list:
    """K5 and K6 at b = 256 on the tall cell's first window: within the
    tolerance of their plain versions, timed (events, device time) beside
    their bound, the plain version and the stepped wide route doing the
    same work, with the wide kernel's shared memory, blocks per SM and
    registers. The bound counts K6's FLOPs as the kernel's b = 128 record
    counts them."""
    b, comm, f = WIDE_B, SimComm(P), 4.0
    tol = ref.tolerances(torch.float32)[0]
    leaf_f = leaf_cost(1, M_LOC, b, 0)[0]
    apply_f = 4.0 * M_LOC * b * N + b * b * N

    def k1_k2():
        Yl, Tl, _ = ops.panel_qr(A[..., :b], 0)
        return ops.wy_apply(Yl, Tl, A)

    s0 = sm.initial_sweep_state(comm, A, b)
    pts = sm.panel_points(s0.geom)
    cases = {
        "panel_qr_apply": dict(
            run=lambda: ops.panel_qr_apply(A, 0, b),
            plain=lambda: ref.panel_qr_apply(A, 0, b), stepped=k1_k2,
            stepped_route="K1+K2 wide (panel_qr, wy_apply)", levels=0,
            flops=P * (leaf_f + apply_f),
            nbytes=f * P * (2 * M_LOC * N + M_LOC * b + 2 * b * b + b * N)),
        "fused_panel": dict(
            run=lambda: ops.fused_panel(A, 0, b=b, m_loc_pad=M_LOC, levels=L),
            plain=lambda: ref.fused_panel(A, 0, b=b, m_loc_pad=M_LOC, levels=L),
            stepped=lambda: sm.run_steps(comm, s0, pts),
            stepped_route="the stepped wide panel (K1, 3 x K3, K2, 3 x K4)",
            levels=L,
            flops=P * (leaf_f + apply_f + L * (b ** 3 + 3.0 * b * b * N)),
            nbytes=f * P * (2 * M_LOC * N + M_LOC * b + (3 + 2 * L) * b * b
                            + (1 + 3 * L) * b * N)),
    }
    recs = []
    for name, c in cases.items():
        got = as_tuple(c["run"]())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = as_tuple(c["plain"]())
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err, scaled = max_err(got, want)
        del got, want
        check(scaled <= tol, f"wide {name}: scaled error {scaled} over {tol}")
        bms, by = bound_ms(c["flops"], c["nbytes"])
        source, replaces = KERNELS[name]
        recs.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            shapes=[list(A.shape)], b=b, max_abs_err=err, scaled_err=scaled,
            tolerance=tol, ms=time_ms(c["run"], 5),
            device_ms=device_ms(c["run"], 5, "fused_wide_kernel"),
            bound_ms=bms, bound_by=by, plain_ms=plain_ms, library_ms=None,
            stepped_ms=time_ms(c["stepped"], 5), stepped_route=c["stepped_route"],
            smem_bytes=tfs.smem_bytes(M_LOC, b, 0, c["levels"]),
            blocks_per_sm=tfs.blocks_per_sm(M_LOC, b, 0, c["levels"]),
            grid=backend.sm_count(0),  # a block an SM (blocks_per_sm is 1)
            ptxas=ptxas(source, "fused_wide_kernel")))
    return recs


def wide_sweeps(A: torch.Tensor, rng) -> dict:
    """The windowed sweep at b = 256 (launch counters at 0 before it): R
    replicated bitwise, the Gram identity, Q^T A = [R; 0], a least-squares
    solve, K1-K4 launched and K5/K6 not; the FT sweep with WIDE_KILLS,
    bit-equal to failure-free; five runs of each (median, min-max)."""
    b, comm = WIDE_B, SimComm(P)
    backend.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = caqr_factorize(A, comm, b, use_scan=False, collect_bundles=True)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(backend.LAUNCHES)
    sub = dict(backend.SUB_LAUNCHES)
    PATH_LAUNCHES["wide"] = launches
    PATH_SUB["wide"] = sub
    check(all(launches[op] > 0 for op in STEPPED)
          and launches["panel_qr_apply"] == launches["fused_panel"] == 0
          and sub["wide_gemm_kernel"] > 0, f"wide sweep launches {launches} {sub}")
    probe = backend.probe_report()
    check(all(probe[op]["engine"] == backend.ENGINE_CUDA for op in STEPPED),
          f"wide: an op did not run its kernels: {probe}")
    check(bool((res.R == res.R[:1]).all()), "wide: R is not replicated bitwise")
    A64 = A.reshape(-1, N).double()
    R0 = res.R[0]
    gram = gram_error(A64, R0)
    check(gram <= GRAM_TOL, f"wide Gram identity: {gram} > {GRAM_TOL}")
    QtA = caqr_apply_qt(A, res.factors, comm).reshape(-1, N)
    rmax = float(R0.abs().max())
    top = float((QtA[:N] - R0).abs().max()) / rmax
    rest = float(QtA[N:].abs().max()) / rmax
    del QtA
    check(max(top, rest) <= QTA_TOL, f"wide: Q^T A != [R; 0]: {top}, {rest}")
    rhs = block_row_layout(rng.standard_normal((P * M_LOC, 1)).astype(np.float32), P)
    x = caqr_lstsq(A, rhs, comm, b, result=res._replace(bundles=None)).double()
    b64 = rhs.reshape(-1, 1).double()
    x_ne = torch.linalg.solve(A64.T @ A64, A64.T @ b64)
    lst = float((x - x_ne).norm() / x_ne.norm())
    check(lst <= LSTSQ_TOL, f"wide lstsq vs normal equations: {lst}")
    del A64, x, x_ne
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = flat_result(res)
    del res
    kill = kill_check(A, comm, WIDE_KILLS, want, b=b)
    PATH_LAUNCHES["wide_kill"] = kill["launches"]
    PATH_SUB["wide_kill"] = kill["sub_launches"] = dict(backend.SUB_LAUNCHES)
    del kill["ledger"]
    fused = wide_fused_sweeps(A, want)
    del want
    sched = FailureSchedule(events={pt: [lane] for pt, lane in WIDE_KILLS.items()})

    def state_machine_fused():
        s = sm.initial_sweep_state(comm, A, b)
        while s.cursor is not None:
            s = sm.run_panel_fused(comm, s)
        return sm.finalize(comm, s)

    spread = {}
    for name, fn in (("caqr_factorize", lambda: caqr_factorize(
                          A, comm, b, use_scan=False, collect_bundles=True)),
                     ("ft_sweep_two_kills", lambda: ft_caqr_sweep(
                          A, comm, b, schedule=sched)),
                     ("state_machine_fused", state_machine_fused)):
        times = []
        for _ in range(SPREAD_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del out
        times.sort()
        spread[name] = dict(median_s=times[len(times) // 2], min_s=times[0],
                            max_s=times[-1], runs=times)
    m = P * M_LOC
    return dict(shape=[m, N], P=P, b=b, panels=N // b, levels=L,
                seconds=seconds,
                gflops=(2.0 * m * N * N - 2.0 * N ** 3 / 3.0) / seconds / 1e9,
                launches=launches, sub_launches=sub, gram_rel_err=gram,
                qta_top_rel_err=top, qta_rest_rel=rest, lstsq_rel_err=lst,
                peak_mem_gb=peak, kill=kill, fused=fused, spread=spread)


def wide_fused_sweeps(A: torch.Tensor, want: tuple) -> dict:
    """K6 above 128 columns on the b = 256 sweep (counters at 0 before
    each path): ``run_panel_fused`` over the 16 panels (path
    ``wide_fused``), bit-equal to the failure-free sweep and to the stepped
    state machine at every panel boundary; the online sweep with fused
    segments and the WIDE_END_KILLS (path ``wide_online_fused``), bit-equal
    to the failure-free sweep and to the stepped online sweep with the same
    kills, with the scheduled run's ledger."""
    b = WIDE_B
    res, seconds, launches, mem = timed_sweep(A, fused=True, b=b)
    same = same_bits(flat_result(res), want)
    del res
    PATH_LAUNCHES["wide_fused"] = launches
    sub = dict(backend.SUB_LAUNCHES)
    check(same, "wide: the fused sweep differs from caqr_factorize")
    check(launches["fused_panel"] == N // b
          and all(launches[op] == 0 for op in STEPPED) and not any(sub.values()),
          f"wide fused sweep launches {launches} {sub}")
    boundaries = lockstep(A, b)
    ends = {pt: [lane] for pt, lane in WIDE_END_KILLS.items()}
    got_f, stats_f, launch_f = online_run(A, ends, b=b, fused=True)
    got_s, stats_s, launch_s = online_run(A, ends, b=b)
    PATH_LAUNCHES["wide_online_fused"] = launch_f
    sched = ft_caqr_sweep(A, SimComm(P), b, schedule=FailureSchedule(events=ends))
    online_ok = dict(
        fused_equals_free=same_bits(flat_result(got_f), want),
        fused_equals_stepped=same_bits(flat_result(got_f), flat_result(got_s)),
        ledger_equals_scheduled=ledger(got_f.events) == ledger(sched.events)
        == ledger(got_s.events))
    del got_f, got_s, sched
    check(all(online_ok.values()), f"wide online fused: {online_ok}")
    check(launch_f["fused_panel"] > 0, f"wide online fused launches {launch_f}")
    return dict(seconds=seconds, launches=launches, sub_launches=sub,
                peak_mem_gb_above_live=mem,
                equals_sweep=same, boundaries_bitwise=boundaries,
                online=dict(**online_ok, fused=stats_f, stepped=stats_s,
                            fused_launches=launch_f, stepped_launches=launch_s))


def muon_run(cfg, dcfg, d: str, orths: list, keep: dict) -> tuple:
    """The plain ``Trainer(caqr_muon)`` for MUON_STEPS steps; every
    ``_orth2d`` call timed (synchronised around it) into ``orths`` as
    (step, shape, seconds), and step 0's momentum slices and their Q kept in
    ``keep``. Returns (trainer, run record)."""
    from repro_torch.optim import caqr_muon as t_muon

    orth2d = t_muon._orth2d
    tr = Trainer(cfg, train_tcfg(d, steps=MUON_STEPS), dcfg)

    def timed(M, tile_rows=512):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Q = orth2d(M, tile_rows)
        torch.cuda.synchronize()
        step = len(tr.history)
        orths.append((step, tuple(M.shape), time.perf_counter() - t0))
        if step == 0:
            keep.setdefault(tuple(M.shape), []).append((M.clone(), Q.clone()))
        return Q

    t_muon._orth2d = timed
    try:
        return tr, train_run(tr)
    finally:
        t_muon._orth2d = orth2d


def muon_runs(seed: int, d: str) -> dict:
    """The plain CAQR-Muon trainer at TinyLlama's full width (2 layers),
    twice: bit-equal params and losses, finite losses, every full-rank
    momentum slice's Q orthonormal, K1 at the path's shapes against its
    plain version on momentum slices, K1 launched."""
    cfg, dcfg = train_configs(seed)
    backend.reset_launches()
    orths, keep = [], {}
    tr, first = muon_run(cfg, dcfg, d, orths, keep)
    PATH_LAUNCHES["muon"] = dict(first["launches"])
    PATH_SUB["muon"] = sub = dict(backend.SUB_LAUNCHES)
    params = tr.state.params
    del tr
    tr2, second = muon_run(cfg, dcfg, d, [], {})
    same = same_tree(tr2.state.params, params) and second["losses"] == first["losses"]
    del tr2, params
    check(same, "muon: two runs differ")
    check(all(np.isfinite(x) for x in first["losses"]),
          f"muon: a loss is not finite {first['losses']}")
    check(first["launches"]["panel_qr"] > 0 and sub["wide_gemm_kernel"] == 0
          and sub["panel_qr_kernel"] == 0,
          f"muon: K1's wide launch not alone {first['launches']} {sub}")
    # Q orthonormal for every full-rank momentum slice of step 0; K1 at the
    # path's shapes against its plain version on those slices
    orth_err, full_rank, k1 = 0.0, 0, {}
    for shape, pairs in keep.items():
        for M, Q in pairs:
            A = M if M.shape[0] >= M.shape[1] else M.T
            Qt = Q if Q.shape[0] >= Q.shape[1] else Q.T
            n = A.shape[1]
            if leading_rank(A[None], n) < n:
                continue
            full_rank += 1
            G = Qt.double().T @ Qt.double()
            orth_err = max(orth_err, float((G - torch.eye(n, device=G.device,
                                                          dtype=G.dtype)).abs().max()))
        M = pairs[0][0]
        A = (M if M.shape[0] >= M.shape[1] else M.T).contiguous()
        m, n = A.shape
        for name, (mm, bb) in MUON_K1.items():
            if bb != n or name in k1:
                continue
            tile = MUON_K1["wk_leaf"][0]  # the chain's tile rows
            if name == "wk_step":
                X = torch.cat([ops.panel_qr(A[:tile], 0)[2], A[tile:2 * tile]])
            elif name == "wk_leaf":
                X = A[:tile].contiguous()
            elif mm == m:
                X = A
            else:
                continue
            k1[name] = muon_k1_check(X)
    check(full_rank > 0 and orth_err <= 1e-3,
          f"muon: Q^T Q off I by {orth_err} over {full_rank} full-rank slices")
    check(set(k1) == set(MUON_K1), f"muon: K1 held at {sorted(k1)} only")
    steps = first["step_seconds"]
    by_step = {}
    for step, shape, sec in orths:
        key = str(list(shape))
        by_step.setdefault(step, {}).setdefault(key, 0.0)
        by_step[step][key] += sec
    share = {step: {k: v / steps[step] for k, v in per.items()}
             for step, per in by_step.items()}
    return dict(arch=TRAIN_ARCH, n_layers=cfg.n_layers, d_model=cfg.d_model,
                d_ff=cfg.d_ff, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                steps=MUON_STEPS, reduced=TRAIN_REDUCED, first=first,
                second=second, bitwise_equal=same, sub_launches=sub,
                orth2d_calls_per_step=len(orths) // MUON_STEPS,
                orth2d_seconds_by_step_and_shape=by_step,
                orth2d_share_of_step=share,
                full_rank_slices=full_rank, qtq_max_err=orth_err, k1=k1)


def conditioned_rank(X: torch.Tensor, limit: float) -> int:
    """How many leading columns of X (m, n) have a float64 condition number
    of at most ``limit`` (it grows with the columns, so a bisection on the
    leading blocks of X's R factor finds it)."""
    R = torch.linalg.qr(X.double(), mode="r").R
    lo, hi = 0, X.shape[1]
    while lo < hi:
        mid = (lo + hi + 1) // 2
        s = torch.linalg.svdvals(R[:mid, :mid])
        lo, hi = (mid, hi) if s[0] <= limit * s[-1] else (lo, mid - 1)
    return lo


def muon_k1_check(X: torch.Tensor) -> dict:
    """K1 on a Muon path's panel X (a momentum slice or a chain step)
    against its plain version. A momentum's trailing columns can be near
    dependent: f32 round-off then moves its reflectors in any QR, by up to
    eps cond. So K1 is held within the tolerance on the leading columns
    whose condition number is at most 1 / DEPENDENT_PIVOT (eps times it
    stays under the tolerance), and on the columns ``leading_rank`` keeps
    it is held against the float64 plain version no worse than four times
    the f32 plain version's own error there."""
    tol = ref.tolerances(torch.float32)[0]
    n = X.shape[1]
    got = as_tuple(ops.panel_qr(X, 0))
    want = as_tuple(ref.panel_qr(X, 0))
    cond_rank = conditioned_rank(X, 1 / DEPENDENT_PIVOT)
    pivot_rank = leading_rank(X[None], n)
    _, held = max_err(determined("panel_qr", got, cond_rank),
                      determined("panel_qr", want, cond_rank))
    want64 = as_tuple(ref.panel_qr(X.double(), 0))
    _, err_k = max_err(determined("panel_qr", got, pivot_rank),
                       determined("panel_qr", want64, pivot_rank))
    _, err_p = max_err(determined("panel_qr", want, pivot_rank),
                       determined("panel_qr", want64, pivot_rank))
    del got, want, want64
    check(held <= tol, f"muon: K1 at {tuple(X.shape)}: scaled error {held} "
          f"over the first {cond_rank} columns")
    check(err_k <= max(4 * err_p, tol), f"muon: K1 at {tuple(X.shape)}: "
          f"{err_k} from float64 against the plain version's {err_p}")
    return dict(shape=list(X.shape), conditioned_rank=cond_rank,
                scaled_err=held, leading_rank=pivot_rank,
                float64_err_kernel=err_k, float64_err_plain=err_p)


def wide_phase(A: torch.Tensor, rng, seed: int, card: str) -> list:
    """K1-K4 above 128 columns: their records at b = 256 and at the Muon
    path's shapes, the bitwise contracts, the b = 256 sweep and FT sweep,
    and the plain CAQR-Muon trainer at TinyLlama's width (see the module
    docstring). Returns the kernel records."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.Generator().manual_seed(seed + 5)
    recs, contracts = wide_kernels(A, g)
    gemm_rec = gemm_record(A, g)
    sweeps = wide_sweeps(A, rng)
    emit({"wide": dict(**sweeps, contracts=contracts, card=card)})
    with deterministic_mode(), tempfile.TemporaryDirectory() as d:
        muon = muon_runs(seed, d)
    muon["phase_seconds"] = time.perf_counter() - t_phase
    emit({"muon": dict(**muon, card=card)})
    return recs, gemm_rec


def gemm_record(A: torch.Tensor, g: torch.Generator) -> dict:
    """The products' kernel of the wide routes (csrc/wide.cu) alone, at the
    b = 256 sweep's first leaf apply: Z = Y^T C, Y (8, 4096, 256), C the
    (8, 4096, 4096) window, against its plain version and torch.matmul,
    and bit-equal at two column tiles. Its launches are counted inside the
    wide calls (backend.SUB_LAUNCHES)."""
    Y = torch.randn(P, M_LOC, WIDE_B, generator=g).to(A.device)
    run = lambda: wide.gemm(Y.mT, A)  # noqa: E731
    got = run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = wide.gemm_plain(Y.mT, A)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, scaled = max_err((got,), (want,))
    tol = ref.tolerances(torch.float32)[0]
    check(scaled <= tol, f"wide_gemm: scaled error {scaled} over {tol}")
    check(torch.equal(got, wide.gemm(Y.mT, A, bn=32)), "wide_gemm: bn changes bits")
    del got, want
    bms, by = bound_ms(2.0 * P * WIDE_B * M_LOC * N,
                       4.0 * P * (M_LOC * WIDE_B + M_LOC * N + WIDE_B * N))
    return dict(name="wide_gemm", route="cuda", source="src/repro_torch/csrc/wide.cu",
                replaces=KERNELS["wy_apply"][1],
                also_inside=[KERNELS["panel_qr"][1], KERNELS["stacked_apply"][1]],
                shapes=[[P, WIDE_B, M_LOC], [P, M_LOC, N]], launches=0,
                max_abs_err=err, scaled_err=scaled, tolerance=tol,
                ms=time_ms(run, 10), device_ms=device_ms(run, 10, "wide_gemm"),
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=time_ms(lambda: Y.mT @ A, 10),
                ptxas=ptxas("src/repro_torch/csrc/wide.cu", "wide_gemm_kernel"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    build.build_all()
    emit({"build_seconds": time.perf_counter() - t0, "card": card})

    rng = np.random.default_rng(args.seed)
    A = block_row_layout(rng.standard_normal((P * M_LOC, N)).astype(np.float32), P)
    emit({"team": team_record()})
    records = kernel_phase(A)
    launches, sweep_seconds, res = sweep_phase(A, rng)
    want = flat_result(res)
    del res
    profile_phase(A, sweep_seconds)
    launches.update({"panel_qr_apply": fused_leaf_phase(A)["panel_qr_apply"]})
    launches.update({"fused_panel": state_machine_phase(A, want)["fused_panel"]})
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    ledgers = ft_driver_phase(A, want)
    online_phase(A, want, ledgers)
    spmd_phase(A, want, ledgers, args.seed)
    del want
    shrink_phase(A)
    recovery_phase(A)
    square_phase(rng)
    ragged_phase(rng)
    serve_phase(args.seed, card)
    train_phase(args.seed, card)
    moe_phase(args.seed, card)
    wide_records, gemm_rec = wide_phase(A, rng, args.seed, card)
    spread_phase(A)
    for rec in records:
        rec["launches_by_path"] = {path: counts[rec["name"]]
                                   for path, counts in PATH_LAUNCHES.items()}
    gemm_rec["launches"] = PATH_SUB["wide"]["wide_gemm_kernel"]
    gemm_rec["launches_by_path"] = {path: counts["wide_gemm_kernel"]
                                    for path, counts in PATH_SUB.items()}
    check(all(gemm_rec["launches_by_path"][p] for p in ("wide", "wide_kill")),
          f"wide_gemm not launched on a wide path: {gemm_rec['launches_by_path']}")
    records.append(gemm_rec)
    emit({"wide_kernels": wide_records})
    print(card, flush=True)
    emit({"kernels": records})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
