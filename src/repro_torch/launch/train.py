"""Training driver of the port (counterpart of ``src/repro/launch/train.py``):

    python -m repro_torch.launch.train [--arch tinyllama-1.1b] [--full]
        [--optimizer adamw|caqr_muon] [--steps N] [--fail STEP:LANE,...]
        [--device cuda|cpu]

The smoke-scale config by default, ``--full`` for the published one. The
tensors live on ``--device`` (the card by default; without a GPU it
raises unless given ``--device cpu``). On the card it turns on
``torch.use_deterministic_algorithms`` and sets
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` before CUDA starts, so a REBUILD
replay is bit-identical to the failure-free run, and turns TF32 off.
"""
from __future__ import annotations

import argparse
import os

from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.ft.failures import FailureSchedule
from repro_torch.ft.semantics import Semantics


def deterministic_cuda() -> None:
    """What bit-identical training on the card needs: cuBLAS's fixed
    workspace (before CUDA starts), deterministic scatter-adds in the
    embedding's and the loss's backward, and no TF32."""
    import torch

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "caqr_muon"])
    ap.add_argument("--semantics", default="rebuild",
                    choices=[s.value for s in Semantics])
    ap.add_argument("--fail", default="",
                    help="failure schedule, e.g. '17:2,30:1' (step:lane)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the trainer (default: cuda)")
    args = ap.parse_args(argv)

    if args.device.startswith("cuda"):
        deterministic_cuda()
    from repro_torch.train import TrainConfig, Trainer

    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                      global_batch=args.global_batch)
    tcfg = TrainConfig(
        steps=args.steps, lr=args.lr, n_lanes=args.lanes,
        optimizer=args.optimizer, semantics=Semantics(args.semantics),
        ckpt_every=50 if args.ckpt_dir else 0,
        ckpt_dir=args.ckpt_dir or "/tmp/repro_ckpt",
    )
    schedule = None
    if args.fail:
        events = {}
        for part in args.fail.split(","):
            s, lane = part.split(":")
            events.setdefault(int(s), []).append(int(lane))
        schedule = FailureSchedule(events=events)
    Trainer(cfg, tcfg, dcfg, device=args.device).run(schedule)


if __name__ == "__main__":
    main()
