"""Serving launcher of the port (counterpart of ``src/repro/launch/serve.py``):

    python -m repro_torch.launch.serve [--arch tinyllama-1.1b] [--full]
        [--ckpt DIR] [--batch 4] [--prompt-len 32] [--max-new 32]
        [--temperature 0.0] [--device cuda|cpu]

Loads a checkpoint if given (params only, ``ckpt/save.py::restore_params``;
else a random init from seed 0), then serves synthetic batched requests
through the prefill + cached-decode engine and prints the tokens; a VLM
gets random patch embeddings and an encoder-decoder model random frame
embeddings (the stub frontends), drawn after the prompts as the JAX
package's launcher draws them. The
smoke-scale config by default, ``--full`` for the published one. The
tensors live on ``--device`` (the card by default; without a GPU it raises
unless given ``--device cpu``); on the card the deterministic mode of
``launch/train.py`` is set before CUDA starts.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.ckpt import save as ckpt_save
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.train import deterministic_cuda
from repro_torch.models import transformer as tf
from repro_torch.serve import Engine, ServeConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b", choices=sorted(ARCHS))
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        deterministic_cuda()
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    if args.ckpt:
        # params-only restore: serving has no optimizer skeleton to offer
        # as the opt_like template
        params, _ = ckpt_save.restore_params(args.ckpt, tf.param_template(cfg))
    else:
        params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    engine = Engine(cfg, params, ServeConfig(
        max_new_tokens=args.max_new, temperature=args.temperature), device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)
    extras = {}
    if cfg.vlm is not None:
        extras["patch_embeds"] = rng.standard_normal(
            (args.batch, cfg.vlm.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.encoder is not None:
        extras["enc_frames"] = rng.standard_normal(
            (args.batch, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    out = engine.generate(prompts, extras=extras or None)
    print(f"served batch={args.batch}: generated {out.shape}")
    print(out)


if __name__ == "__main__":
    main()
