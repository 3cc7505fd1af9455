"""LR schedules (port of ``src/repro/optim/schedule.py``): float32
0-dim tensors on the host, as the JAX package's are float32 scalars.
Each schedule carries its ``recipe`` (factory, keyword arguments), from
which the rank processes of a pod step rebuild it."""
from __future__ import annotations

import math

import torch


def warmup_cosine(base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step).to(device="cpu", dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clip((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    lr.recipe = (warmup_cosine, dict(base_lr=base_lr, warmup=warmup,
                                     total=total, min_frac=min_frac))
    return lr


def constant(base_lr: float):
    def lr(step):
        return torch.tensor(base_lr, dtype=torch.float32)

    lr.recipe = (constant, dict(base_lr=base_lr))
    return lr
