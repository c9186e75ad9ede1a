"""Serving launcher: batched prefill, then a greedy decode loop
(``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --batch 4 --prompt-len 2048 --gen 32            # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --batch 4 --prompt-len 2048 --gen 32            # RWKV-6, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
        --reduced --device cpu                          # Jamba, Mamba + MoE

Jamba v0.1 at its published depth (32 layers, 51.6 B parameters) needs
103 GB in bf16, more than one 80 GB card holds; ``chip_smoke.py`` serves
one 8-layer period of it at full width (13.3 B parameters). The MoE
models (``qwen2-moe-a2.7b``, ``deepseek-moe-16b``) serve the same way.

Weights are drawn from ``--seed`` (nothing is downloaded) and the prompt is
``--batch`` rows of random tokens from the same seed. It prints the prefill
time, the decode rate and the first row's first 16 tokens. Timings end in
``torch.cuda.synchronize()`` on the card. Without a card it raises unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.models.model import Model

__all__ = ["decode", "generate", "main", "prefill", "prompt_tokens"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(cfg, batch: int, prompt_len: int, seed: int, device) -> torch.Tensor:
    """(batch, prompt_len) random tokens, drawn as the reference's launcher
    draws them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
    return torch.as_tensor(toks, dtype=torch.int64, device=device)


def prefill(model: Model, params, tokens, max_len: int):
    """The prompt's prefill and its greedy next token: returns (logits of the
    last position (B, 1, V), cache, token (B, 1))."""
    logits, cache, _aux = model.prefill(params, {"tokens": tokens}, max_len=max_len)
    return logits, cache, torch.argmax(logits[:, -1:], dim=-1)


def decode(model: Model, params, cache, token, cache_len: int, steps: int):
    """``steps`` greedy decode steps from ``token`` at position
    ``cache_len``; returns (tokens (B, steps), the last step's logits)."""
    out, logits = [], None
    for i in range(steps):
        logits, cache = model.decode(params, cache, token, cache_len + i)
        token = torch.argmax(logits[:, -1:], dim=-1)
        out.append(token)
    return (torch.cat(out, dim=1) if out else token[:, :0]), logits


def generate(model: Model, params, tokens, gen: int) -> dict:
    """Prefill, then ``gen - 1`` greedy decode steps: the reference
    launcher's loop. Returns the ``gen`` tokens (B, gen), the prefill's
    logits and the host-clock seconds of prefill and decode."""
    b, s = tokens.shape
    _sync(model.device)
    t0 = time.perf_counter()
    logits, cache, tok = prefill(model, params, tokens, s + gen)
    _sync(model.device)
    t1 = time.perf_counter()
    rest, _ = decode(model, params, cache, tok, s, gen - 1)
    _sync(model.device)
    t2 = time.perf_counter()
    return {"tokens": torch.cat([tok, rest], dim=1), "prefill_logits": logits,
            "prefill_s": t1 - t0, "decode_s": t2 - t1}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = model.init(args.seed)
    b, s = args.batch, args.prompt_len
    tokens = prompt_tokens(cfg, b, s, args.seed, model.device)

    with torch.inference_mode():
        res = generate(model, params, tokens, args.gen)
    steps = args.gen - 1
    print(f"prefill({b}x{s}) {res['prefill_s']:.2f}s")
    print(f"decoded {steps} steps in {res['decode_s']:.2f}s "
          f"({steps * b / max(res['decode_s'], 1e-9):.1f} tok/s)")
    print("sample:", res["tokens"][0, :16].tolist())


if __name__ == "__main__":
    main()
