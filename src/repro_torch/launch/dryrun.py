"""Dry run of every (arch x shape x mesh) cell on meta tensors (the port's
counterpart of ``src/repro/launch/dryrun.py``).

The reference lowers and compiles each cell's step for 512 forced host
devices and reads XLA's memory and cost analyses. The port has no
compiler between the step and the card, so each cell's step runs once,
eagerly, on tensors of the meta device (shapes and dtypes, no storage):
at the published width and depth, allocating nothing, spawning no rank
and needing no card. Per cell:

* the production mesh (``launch/mesh.py``, a descriptor that spawns
  nothing), the rule table of ``dist/sharding.py`` (the sequence-shard
  rule off for the 'M'/'R' mixers, the decode overrides) and the
  shardings of ``dist/params_sharding.py``;
* the step (``train/step.make_train_step`` with the cell's optimizer,
  ``models/api.make_prefill`` or ``make_serve_step``) run once on the
  meta specs of ``models/api.py`` under
  ``torch.utils.flop_counter.FlopCounterMode``;
* a JSON record in ``experiments/dryrun_torch/`` with the reference's
  keys where they mean something here: ``n_params``,
  ``n_active_params`` and ``model_flops_global`` by the reference's
  formula; ``memory.argument_bytes``, the per-device sum of each
  argument leaf's shard (a dimension that does not divide rounds up, as
  XLA pads), ``output_bytes`` and ``alias_bytes`` (the donated train
  state or caches), ``peak_bytes_analytic`` by the reference's formula;
  ``cost.flops_global`` from the counter and ``cost.flops_per_device``,
  its even split over the chips. XLA's buffer assignment (``temp_bytes``,
  ``peak_bytes_est``, ``bytes_per_device``) has no counterpart and reads
  ``"not_available"``; ``collectives`` is skipped, because the port's
  meshes run manual bodies only and no partitioner inserts collectives.

The ``caqr`` cell: ``caqr_factorize`` of ``paper_qr.PRODUCTION`` over the
QR mesh's 256 (or 512) lanes in the ``SimComm`` layout on meta tensors,
the kernels' plain versions (``kernels/ops.py`` sends meta tensors there,
shape only). Its FLOPs come from the counter; a kernel call whose shapes
and arguments the cell has met before is replayed (meta outputs of the
recorded shapes, the FLOPs the counter recorded for that call), since the
plain versions' column loops would otherwise take most of an hour of
Python at 32 panels of 128 columns over 8 levels. The collective bytes
a lane are counted by a wrapper of ``SimComm``'s ``ppermute``/``psum``.

CLI:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both]   # a subprocess a cell
  python -m repro_torch.launch.dryrun --arch caqr
  python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import time
from typing import Any, Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import tree
from repro_torch.configs import ARCHS, get_config, get_shape, paper_qr
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.core import SimComm, caqr_factorize
from repro_torch.dist import params_sharding as psh
from repro_torch.dist import sharding as shd
from repro_torch.dist.compat import PartitionSpec as P, spec_axes
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh, make_qr_mesh
from repro_torch.models import api
from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import constant
from repro_torch.train.step import TrainState, make_train_step

# Per-arch knobs, the reference's: the optimizer chosen so the training
# state fits 16 GiB a chip (adafactor's factored second moment is what lets
# the 1T-parameter kimi cell fit) and the layers a remat span holds.
TRAIN_KNOBS: Dict[str, Dict[str, Any]] = {
    "kimi-k2-1t-a32b": dict(opt="adafactor", remat_group=4),
    "nemotron-4-340b": dict(opt="adafactor", remat_group=4),
    "mixtral-8x22b": dict(opt="adafactor", remat_group=4),
    "mamba2-2.7b": dict(opt="adamw", remat_group=8),
    "recurrentgemma-9b": dict(opt="adamw", remat_group=2),
    "gemma2-2b": dict(opt="adamw", remat_group=2),
}

SRC = pathlib.Path(__file__).resolve().parents[2]
OUT_DIR = SRC.parent / "experiments" / "dryrun_torch"
NOT_AVAILABLE = "not_available"
NO_COLLECTIVES = ("the port's meshes run manual bodies only; no partitioner "
                  "inserts collectives into a step")
EVEN_SPLIT = "flops_global / n_chips (an even split, not a per-device count)"


def _model_flops(cfg: ModelConfig, shape: ShapeConfig):
    """MODEL_FLOPS = 6 N D (dense) or 6 N_active D for training, 2 N D a
    generated token for decode; returns (flops, n_params, n_active)."""
    leaves = tree.flatten_with_path(api.param_specs(cfg))
    n_params = sum(leaf.numel() for _, leaf in leaves)
    if cfg.moe is not None:
        # active = non-expert params + top_k / E of the expert params
        expert = sum(leaf.numel() for path, leaf in leaves
                     if any(w in path for w in ("w_gate", "w_in", "w_out"))
                     and leaf.dim() >= 4)
        n_active = n_params - expert + expert * cfg.moe.top_k / cfg.moe.n_experts
    else:
        n_active = n_params
    tokens = shape.global_batch * (1 if shape.is_decode else shape.seq_len)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens, n_params, n_active


def _optimizer(name: str):
    return adafactor() if TRAIN_KNOBS.get(name, {}).get("opt") == "adafactor" \
        else adamw()


def _parts(mesh, spec: P, d: int) -> int:
    if d >= len(spec):
        return 1
    return math.prod(mesh.shape[a] for a in spec_axes(spec[d]))


def shard_bytes(leaf, sharding) -> int:
    """Bytes of one device's shard of ``leaf``: each dimension divided by
    its mesh axes, rounded up."""
    shape = [-(-n // _parts(sharding.mesh, sharding.spec, d))
             for d, n in enumerate(leaf.shape)]
    return math.prod(shape) * leaf.element_size()


def device_bytes(t, shardings) -> int:
    """The per-device bytes of a tree under a tree of ``NamedSharding``."""
    return sum(shard_bytes(x, s) for x, s in zip(tree.leaves(t),
                                                 tree.leaves(shardings)))


def _replicated(t, mesh):
    return tree.map(lambda _: psh.NamedSharding(mesh, P()), t)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, multi_pod: bool):
    """Returns (fn, args, in_shardings, out_shardings, donated, rules,
    specs): ``out_shardings(out)`` gives the shardings of the step's
    outputs, ``donated`` the indices of the arguments the step updates in
    place and ``specs`` the arguments as specs (``args`` with the decode
    position's 0-dim int32 spec in place of its int)."""
    fsdp = ("pod", "data") if multi_pod else "data"
    rules = shd.multi_pod_rules() if multi_pod else shd.single_pod_rules()
    batch_axes = rules["batch"]
    params = api.param_specs(cfg)
    p_sh = psh.tree_shardings(params, mesh, fsdp)

    if shape.kind == "train":
        # sequence parallelism on the residual stream, except for the
        # recurrent mixers, whose scans run over the sequence dim
        kinds = {cfg.mixer_at(i) for i in range(cfg.n_layers)}
        rules["seq_shard"] = None if kinds & {"M", "R"} else "model"
        opt = _optimizer(cfg.name)
        step = make_train_step(cfg, opt, constant(1e-3))
        opt_state = opt.init(params)
        batch = api.train_input_specs(cfg, shape)
        state = TrainState(params, opt_state, torch.zeros((), dtype=torch.int32))
        state_sh = TrainState(p_sh, psh.tree_shardings(opt_state, mesh, fsdp),
                              psh.NamedSharding(mesh, P()))
        b_sh = psh.batch_shardings(batch, mesh, batch_axes)
        args = (state, batch)
        return (step, args, (state_sh, b_sh),
                lambda out: (state_sh, _replicated(out[1], mesh)), (0,), rules,
                args)

    if shape.kind == "prefill":
        batch = api.train_input_specs(cfg, shape)
        batch.pop("labels")
        b_sh = psh.batch_shardings(batch, mesh, batch_axes)
        args = (params, batch)
        return (api.make_prefill(cfg), args, (p_sh, b_sh),
                lambda out: (psh.batch_shardings(out[0], mesh, batch_axes),
                             psh.cache_shardings(out[1], mesh, batch_axes,
                                                 rules["kv_seq_shard"])),
                (), rules, args)

    # decode
    if shape.name == "long_500k":
        rules = shd.long_decode_overrides(rules)
        batch_axes = rules["batch"]
    else:
        # decode_32k: the cache's sequence dim shards over the model axis
        rules["kv_seq_shard"] = "model"
    specs = api.decode_input_specs(cfg, shape)
    cache_sh = psh.cache_shardings(specs["caches"], mesh, batch_axes,
                                   rules["kv_seq_shard"])
    # the port's decode step takes the position as a Python int: the last
    # slot of the cache
    args = [params, specs["token"], shape.seq_len - 1, specs["caches"]]
    shardings = [p_sh, psh.batch_shardings(specs["token"], mesh, batch_axes),
                 psh.NamedSharding(mesh, P()), cache_sh]
    if cfg.encoder is not None:
        args.append(specs["enc_out"])
        shardings.append(psh.batch_shardings(specs["enc_out"], mesh, batch_axes))
    spec_args = list(args)
    spec_args[2] = specs["pos"]
    return (api.make_serve_step(cfg), tuple(args), tuple(shardings),
            lambda out: (psh.batch_shardings(out[0], mesh, batch_axes),
                         cache_sh), (3,), rules, tuple(spec_args))


def _write(rec: Dict, out_dir, name: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir=OUT_DIR) -> Dict:
    multi_pod = mesh_kind == "multi"
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, why = api.supports_shape(cfg, shape)
    if not ok:
        print(f"SKIP {arch} x {shape_name}: {why}")
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": why}
    if shape.kind == "train":
        cfg = dataclasses.replace(cfg, remat_group=TRAIN_KNOBS.get(
            arch, {}).get("remat_group", 1))
    fn, args, in_sh, out_sh, donated, rules, specs = build_cell(
        cfg, shape, mesh, multi_pod)
    t0 = time.perf_counter()
    with shd.use_rules(rules), FlopCounterMode(display=False) as counter:
        out = fn(*args)
    t_trace = time.perf_counter() - t0
    flops = float(counter.get_total_flops())

    n_chips = mesh.size
    arg_b = sum(device_bytes(a, s) for a, s in zip(specs, in_sh))
    out_b = sum(device_bytes(o, s) for o, s in zip(out, out_sh(out)))
    alias_b = sum(device_bytes(specs[i], in_sh[i]) for i in donated)
    mf, n_params, n_active = _model_flops(cfg, shape)
    if shape.kind == "train":
        # the reference's activation term: scan-carry stashes of the
        # sharded residual, n_groups / remat_group of them
        axes = mesh.shape
        batch_div = axes.get("data", 1) * axes.get("pod", 1)
        kinds = {cfg.mixer_at(i) for i in range(cfg.n_layers)}
        seq_div = 1 if kinds & {"M", "R"} else axes.get("model", 1)
        period = cfg.pattern_period
        n_stash = (max(cfg.n_layers // period // max(cfg.remat_group, 1), 1)
                   + cfg.n_layers % period)
        stash = (shape.global_batch // batch_div) * (shape.seq_len // seq_div) \
            * cfg.d_model * 2 * n_stash
        analytic = arg_b + out_b - alias_b + 3 * stash
    else:
        analytic = arg_b + out_b - alias_b + 2 * 2**30
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "status": "ok",
        "n_chips": n_chips,
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": out_b,
            "temp_bytes": NOT_AVAILABLE,
            "alias_bytes": alias_b,
            "peak_bytes_est": NOT_AVAILABLE,
            "peak_bytes_analytic": analytic,
        },
        "cost": {
            "flops_global": flops,
            "flops_per_device": flops / n_chips,
            "flops_split": EVEN_SPLIT,
            "bytes_per_device": NOT_AVAILABLE,
        },
        "collectives": {"skipped": NO_COLLECTIVES},
        "model_flops_global": float(mf),
        "n_params": int(n_params),
        "n_active_params": int(n_active),
        "optimizer": (TRAIN_KNOBS.get(arch, {}).get("opt", "adamw")
                      if shape.kind == "train" else None),
        "remat_group": cfg.remat_group,
        "n_layers": cfg.n_layers,
        "traced_on": "meta",
        "t_trace_s": round(t_trace, 2),
    }
    _write(rec, out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    print(f"OK {arch} x {shape_name} x {mesh_kind}: args/device "
          f"{arg_b / 2**30:.2f} GiB, peak/device ~{analytic / 2**30:.2f} GiB "
          f"(analytic), flops {flops:.3e} ({t_trace:.1f}s)", flush=True)
    return rec


class CountingComm(SimComm):
    """``SimComm`` that counts the bytes its collectives move: a
    ``ppermute`` one lane's slice for each (source, destination) pair, a
    ``psum`` every lane's slice. On meta tensors they return their result's
    shape alone (neither is a FLOP)."""

    def __init__(self, P: int):
        super().__init__(P)
        self.bytes = 0
        self.calls = {"ppermute": 0, "psum": 0}

    def ppermute(self, x: torch.Tensor, perm):
        self.bytes += len(perm) * x[0].numel() * x.element_size()
        self.calls["ppermute"] += 1
        if x.device.type == "meta":
            return torch.empty_like(x)
        return super().ppermute(x, perm)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        self.bytes += x.numel() * x.element_size()
        self.calls["psum"] += 1
        if x.device.type == "meta":
            return torch.empty_like(x)
        return super().psum(x)


def _signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype)
    return repr(x)


@contextlib.contextmanager
def replay_kernels(counter: FlopCounterMode):
    """Within the block, a kernel op of ``ops`` called on meta tensors
    with shapes and arguments met before returns meta outputs of the
    recorded shapes and adds the FLOPs the counter recorded for its first
    call to ``state["replayed_flops"]``; a first call runs the plain
    version under ``counter``. Calls on other devices pass through."""
    state = {"replayed_flops": 0, "traced": 0, "replayed": 0}
    cache: Dict[tuple, tuple] = {}
    saved = {name: getattr(ops, name) for name in
             ("panel_qr", "wy_apply", "stacked_qr", "stacked_apply")}

    def wrap(name, fn):
        def call(*args, **kw):
            if not any(isinstance(a, torch.Tensor) and a.device.type == "meta"
                       for a in args):
                return fn(*args, **kw)
            key = (name, tuple(map(_signature, args)),
                   tuple(sorted((k, _signature(v)) for k, v in kw.items())))
            if key not in cache:
                f0 = counter.get_total_flops()
                out = fn(*args, **kw)
                outs = out if isinstance(out, tuple) else (out,)
                cache[key] = (counter.get_total_flops() - f0,
                              [(o.shape, o.dtype) for o in outs],
                              isinstance(out, tuple))
                state["traced"] += 1
                return out
            flops, shapes, is_tuple = cache[key]
            state["replayed_flops"] += flops
            state["replayed"] += 1
            outs = tuple(torch.empty(s, dtype=d, device="meta") for s, d in shapes)
            return outs if is_tuple else outs[0]
        return call

    for name, fn in saved.items():
        setattr(ops, name, wrap(name, fn))
    try:
        yield state
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def caqr_counts(m_rows: int, n_cols: int, panel: int, lanes: int,
                device="meta", seed: int = 0) -> Dict:
    """``caqr_factorize`` of an (m_rows x n_cols) f32 matrix over ``lanes``
    lanes of ``SimComm`` on ``device`` (on the CPU a matrix from a seeded
    numpy generator) under the FLOP counter: its FLOPs, the collectives'
    bytes, the result and the kernel calls traced and replayed."""
    shape = (lanes, m_rows // lanes, n_cols)
    if torch.device(device).type == "meta":
        A = torch.empty(shape, dtype=torch.float32, device="meta")
    else:
        rng = np.random.default_rng(seed)
        A = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device)
    comm = CountingComm(lanes)
    with FlopCounterMode(display=False) as counter, \
            replay_kernels(counter) as replay:
        res = caqr_factorize(A, comm, panel)
    return dict(flops=float(counter.get_total_flops() + replay["replayed_flops"]),
                comm_bytes=comm.bytes, comm_calls=dict(comm.calls), result=res,
                A=A, kernel_calls={k: replay[k] for k in ("traced", "replayed")})


def run_caqr_cell(mesh_kind: str, out_dir=OUT_DIR,
                  qr: paper_qr.QRConfig = paper_qr.PRODUCTION) -> Dict:
    """The paper's own workload: FT-CAQR of a general matrix over the QR
    mesh, one lane a chip."""
    mesh = make_qr_mesh(multi_pod=mesh_kind == "multi", device="meta")
    lanes = mesh.size
    t0 = time.perf_counter()
    c = caqr_counts(qr.m_rows, qr.n_cols, qr.panel, lanes)
    lane_bytes = lambda x: x[0].numel() * x.element_size()  # noqa: E731
    res = c["result"]
    mf = 2 * qr.m_rows * qr.n_cols**2 - (2 / 3) * qr.n_cols**3
    rec = {
        "arch": "caqr", "shape": f"qr_{qr.m_rows}x{qr.n_cols}_b{qr.panel}",
        "mesh": mesh_kind, "status": "ok", "n_chips": lanes,
        "memory": {
            "argument_bytes": lane_bytes(c["A"]),
            "output_bytes": lane_bytes(res.R),
            # every field of the factors holds one equal slice a lane
            "factors_bytes": sum(x.numel() * x.element_size()
                                 for x in res.factors) // lanes,
            "temp_bytes": NOT_AVAILABLE,
            "peak_bytes_est": NOT_AVAILABLE,
        },
        "cost": {
            "flops_global": c["flops"],
            "flops_per_device": c["flops"] / lanes,
            "flops_split": EVEN_SPLIT,
            "bytes_per_device": NOT_AVAILABLE,
        },
        "collectives": {
            "bytes_per_lane": c["comm_bytes"] / lanes,
            "bytes_total": c["comm_bytes"],
            "calls": c["comm_calls"],
            "counted_by": "a SimComm wrapper of ppermute and psum",
        },
        "kernel_calls": c["kernel_calls"],
        "model_flops_global": float(mf),
        "traced_on": "meta",
        "t_total_s": round(time.perf_counter() - t0, 2),
    }
    _write(rec, out_dir, f"caqr__{mesh_kind}.json")
    print(f"OK caqr x {mesh_kind}: flops {c['flops']:.3e}, collectives "
          f"{rec['collectives']['bytes_per_lane'] / 2**30:.3f} GiB a lane "
          f"({rec['t_total_s']}s)", flush=True)
    return rec


def all_cells():
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if api.supports_shape(cfg, shape)[0]:
                cells.append((arch, shape.name))
    return cells


def summary(out_dir, meshes) -> str:
    """A markdown table of the cells' records in ``out_dir``."""
    rows = ["| arch | shape | mesh | n_params | flops (global) | argument "
            "bytes a device | seconds |", "|---|---|---|---|---|---|---|"]
    cells = all_cells() + [("caqr", None)]
    for arch, shape in cells:
        for mk in meshes:
            name = (f"caqr__{mk}.json" if shape is None
                    else f"{arch}__{shape}__{mk}.json")
            path = os.path.join(out_dir, name)
            if not os.path.exists(path):
                continue
            with open(path) as f:
                r = json.load(f)
            rows.append(
                f"| {arch} | {r['shape']} | {mk} | {r.get('n_params', '')} | "
                f"{r['cost']['flops_global']:.4e} | "
                f"{r['memory']['argument_bytes']} | "
                f"{r.get('t_trace_s', r.get('t_total_s'))} |")
    return "\n".join(rows)


def _subprocess(*argv) -> int:
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (str(SRC), os.environ.get("PYTHONPATH", "")) if p)}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *argv], env=env).returncode


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args()

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list:
        for a, s in all_cells():
            print(f"{a} x {s}")
        print(f"caqr x qr_{paper_qr.PRODUCTION.m_rows}x{paper_qr.PRODUCTION.n_cols}")
        return

    if args.all:
        failures = []
        for a, s in all_cells():
            for mk in meshes:
                if os.path.exists(os.path.join(args.out, f"{a}__{s}__{mk}.json")):
                    print(f"cached {a} x {s} x {mk}")
                    continue
                if _subprocess("--arch", a, "--shape", s, "--mesh", mk,
                               "--out", args.out):
                    failures.append((a, s, mk))
        for mk in meshes:
            if os.path.exists(os.path.join(args.out, f"caqr__{mk}.json")):
                print(f"cached caqr x {mk}")
            elif _subprocess("--arch", "caqr", "--mesh", mk, "--out", args.out):
                failures.append(("caqr", None, mk))
        print(summary(args.out, meshes))
        if failures:
            print("FAILED CELLS:", failures)
            sys.exit(1)
        print("ALL CELLS OK")
        return

    if not args.arch:
        ap.error("--arch (or --all / --list) is required")
    for mk in meshes:
        if args.arch == "caqr":
            run_caqr_cell(mk, args.out)
        else:
            if not args.shape:
                ap.error("--shape is required for a model cell")
            run_cell(args.arch, args.shape, mk, args.out)


if __name__ == "__main__":
    main()
