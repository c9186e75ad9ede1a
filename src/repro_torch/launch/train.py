"""Training launcher (``repro/launch/train.py``): real optimizer steps of a
zoo model on synthetic bigram batches (``data.pipeline.token_batches``),
on the card unless ``--device`` says otherwise.

  python -m repro_torch.launch.train --arch llama3.2-3b --reduced \
      --steps 20 --batch 8 --seq 128 --device cpu

Each step is ``launch.steps.build_train``'s (loss, backward, gradients
clipped to norm 1, the config's optimizer, the parameters and optimizer
state updated in place, so a step holds one copy of the moments: a
full-width Jamba layer with its 16 experts trains on one card so); every
``--log-every`` steps it
prints ``step i loss=... gnorm=... <seconds>s``. ``--save PATH`` writes the
final parameters with ``checkpoint.save`` (and ``PATH.json`` with the step
count), readable by the reference's ``restore`` too. On the card every
family trains through its kernels: attention, the WKV-6 recurrence
(``rwkv6-7b``) and the Mamba scan (``jamba-v0.1-52b``) each run their
forward kernel and, for the gradient, their backward kernel.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.pipeline import token_batches
from repro_torch.launch.mesh import make_mesh_by_name
from repro_torch.launch.steps import build_train
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import get_optimizer

__all__ = ["main", "with_extras"]


def with_extras(cfg, batch: dict, rng: np.random.Generator, seq: int) -> dict:
    """The reference launcher's batch for ``cfg``'s family: a vlm's text cut
    to ``seq`` less its image tokens, and its image embeddings; an audio
    model's encoder frames (both drawn from ``rng``, scaled by 0.02)."""
    b = dict(batch)
    n = b["tokens"].shape[0]
    if cfg.family == "vlm":
        b["tokens"] = b["tokens"][:, : seq - cfg.num_image_tokens]
        b["labels"] = b["labels"][:, : seq - cfg.num_image_tokens]
        b["image_embeds"] = rng.standard_normal(
            (n, cfg.num_image_tokens, cfg.d_model)).astype(np.float32) * 0.02
    if cfg.family == "audio":
        b["encoder_embeds"] = rng.standard_normal(
            (n, cfg.encoder_seq, cfg.d_model)).astype(np.float32) * 0.02
    return b


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg, device=args.device)
    mesh = make_mesh_by_name(args.mesh)
    step, _, _, _ = build_train(model, mesh)
    opt = get_optimizer(cfg.optimizer, cfg.learning_rate)
    params = model.init(args.seed)
    opt_state = opt.init(params)

    rng = np.random.default_rng(args.seed)
    gen = token_batches(rng, args.batch, args.seq + 1, cfg.vocab_size)
    for i in range(args.steps):
        t0 = time.time()
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in with_extras(cfg, next(gen), rng, args.seq).items()}
        params, opt_state, metrics = step(params, opt_state, batch)
        if i % args.log_every == 0:
            print(f"step {i:4d} loss={metrics['loss'].item():.4f} "
                  f"gnorm={metrics['grad_norm'].item():.3f} {time.time()-t0:.2f}s", flush=True)
    if args.save:
        ckpt.save(args.save, params, step=args.steps)
        print(f"saved params -> {args.save}")


if __name__ == "__main__":
    main()
