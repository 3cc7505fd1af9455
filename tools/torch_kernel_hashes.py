"""Hash the outputs of the PyTorch port's CUDA kernels K1-K6 on fixed,
seeded inputs, to check that a change keeps a kernel's bits.

    PYTHONPATH=<tree>/src python3 tools/torch_kernel_hashes.py [--seed N]

Run it under two source trees on the same card (for example a change and
its parent unpacked with ``git archive``) and compare the printed JSON:
equal hashes mean bit-equal outputs. The f32 keys come first; the keys
that start with "bf16" hash the bf16 kernels at b = 128 and above, on
inputs from a generator of their own. The inputs of K2, K3 and K4 come
from numpy alone, never from another kernel, so their hashes do not move
when K1's bits do. Needs CUDA; imports no JAX.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np
import torch

from repro_torch.kernels import build, ops


def digest(out) -> str:
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out) if k != "tops"]
    if isinstance(out, torch.Tensor):
        out = [out]
    h = hashlib.sha256()
    for x in out:
        x = x.detach().contiguous()
        if x.dtype == torch.bfloat16:  # numpy has no bf16: hash the bits
            x = x.view(torch.int16)
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_kernel_hashes: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    rng = np.random.default_rng(args.seed)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).cuda()

    def factor(P, b):
        return t(np.stack([np.linalg.qr(rng.standard_normal((2 * b, b)))[1]
                           for _ in range(P)]))

    hashes = {}
    # K2: first panel, late panel, one lane, odd shapes
    for P, m, b, n in [(8, 4096, 128, 4096), (8, 4096, 128, 512),
                       (1, 4096, 128, 4096), (3, 300, 128, 259), (2, 37, 5, 13)]:
        Y = t(rng.standard_normal((P, m, b)) * 0.1)
        T = t(np.triu(rng.standard_normal((P, b, b))) * 0.1)
        C = t(rng.standard_normal((P, m, n)))
        hashes[f"wy_apply {P}x{m}x{b} n={n}"] = digest(ops.wy_apply(Y, T, C))
    # K3 and K4
    for P, b, n in [(8, 128, 4096), (8, 128, 512), (1, 128, 4096), (4, 5, 11),
                    (3, 100, 259)]:
        R1, R2 = factor(P, b), factor(P, b)
        hashes[f"stacked_qr {P}x{b}"] = digest(ops.stacked_qr(R1, R2))
        Y2 = t(np.triu(rng.standard_normal((P, b, b))) * 0.1)
        T = t(np.triu(rng.standard_normal((P, b, b))) * 0.1)
        Ct = t(rng.standard_normal((P, b, n)))
        Cb = t(rng.standard_normal((P, b, n)))
        hashes[f"stacked_apply {P}x{b} n={n}"] = digest(
            ops.stacked_apply(Y2, T, Ct, Cb))
    # K1, K5, K6
    for P, m, b, rs in [(8, 4096, 128, 0), (8, 4096, 128, 3968),
                        (3, 512, 128, 384), (3, 37, 5, 2)]:
        hashes[f"panel_qr {P}x{m}x{b} rs={rs}"] = digest(
            ops.panel_qr(t(rng.standard_normal((P, m, b))), rs))
    for P, m, w, b, rs in [(8, 4096, 4096, 128, 0), (3, 512, 300, 128, 0)]:
        hashes[f"panel_qr_apply {P}x{m}x{w} rs={rs}"] = digest(
            ops.panel_qr_apply(t(rng.standard_normal((P, m, w))), rs, b))
    for P, m, w, b, k in [(8, 4096, 4096, 128, 0), (8, 512, 1024, 128, 10)]:
        win = t(rng.standard_normal((P, m, w)))
        hashes[f"fused_panel {P}x{m}x{w} k={k}"] = digest(
            ops.fused_panel(win, k, b=b, m_loc_pad=m, levels=P.bit_length() - 1))
    # bf16, at b = 128 and above (its own generator, so the f32 keys above
    # keep their inputs)
    rng16 = np.random.default_rng(args.seed + 1)

    def b16(*shape, scale=1.0, triu=False):
        x = rng16.standard_normal(shape) * scale
        return t(np.triu(x) if triu else x).to(torch.bfloat16)

    for P, m, b, n in [(8, 4096, 128, 4096), (8, 4096, 256, 4096),
                       (3, 600, 200, 259)]:
        hashes[f"bf16 wy_apply {P}x{m}x{b} n={n}"] = digest(ops.wy_apply(
            b16(P, m, b, scale=0.1), b16(P, b, b, scale=0.1, triu=True),
            b16(P, m, n)))
    for P, b, n in [(8, 128, 4096), (8, 256, 4096)]:
        R1 = t(np.stack([np.linalg.qr(rng16.standard_normal((2 * b, b)))[1]
                         for _ in range(2 * P)])).to(torch.bfloat16)
        hashes[f"bf16 stacked_qr {P}x{b}"] = digest(
            ops.stacked_qr(R1[:P].contiguous(), R1[P:].contiguous()))
        hashes[f"bf16 stacked_apply {P}x{b} n={n}"] = digest(ops.stacked_apply(
            b16(P, b, b, scale=0.1, triu=True), b16(P, b, b, scale=0.1, triu=True),
            b16(P, b, n), b16(P, b, n)))
    for P, m, b, rs in [(8, 4096, 128, 0), (8, 4096, 256, 0), (8, 4096, 256, 3840)]:
        hashes[f"bf16 panel_qr {P}x{m}x{b} rs={rs}"] = digest(
            ops.panel_qr(b16(P, m, b), rs))
    for P, m, w, b in [(8, 4096, 4096, 128), (8, 4096, 4096, 256)]:
        hashes[f"bf16 panel_qr_apply {P}x{m}x{w} b={b}"] = digest(
            ops.panel_qr_apply(b16(P, m, w), 0, b))
        hashes[f"bf16 fused_panel {P}x{m}x{w} b={b}"] = digest(
            ops.fused_panel(b16(P, m, w), 0, b=b, m_loc_pad=m,
                            levels=P.bit_length() - 1))
    torch.cuda.synchronize()
    print(json.dumps(hashes, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
