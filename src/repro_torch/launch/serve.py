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
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-small \\
        --batch 8 --prompt-len 64 --gen 32              # Whisper, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b \\
        --reduced --device cpu                          # InternVL2's vlm path

Jamba v0.1 at its published depth (32 layers, 51.6 B parameters) needs
103 GB in bf16, more than one 80 GB card holds; ``chip_smoke.py`` serves
one 8-layer period of it at full width (13.3 B parameters). The MoE
models (``qwen2-moe-a2.7b``, ``deepseek-moe-16b``) serve the same way.

InternVL2-76B at its published depth (80 layers) needs about 150 GB in
bf16; ``chip_smoke.py`` serves 2 of its layers at full width.

Weights are drawn from ``--seed`` (nothing is downloaded) and the prompt is
``--batch`` rows of random tokens from the same seed, then, as the
reference's launcher draws them, the stubbed frontends' outputs: Whisper's
``encoder_embeds`` (B, 1500 frames, d) and InternVL2's ``image_embeds`` (B,
256 image tokens, d), standard normals times 0.02. The vlm's image tokens
go ahead of the text, so its decode starts at position 256 + the prompt. It prints the prefill
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

__all__ = ["decode", "generate", "main", "prefill", "prompt_batch", "prompt_tokens",
           "start_position"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prompt_tokens(cfg, batch: int, prompt_len: int, seed: int, device) -> torch.Tensor:
    """(batch, prompt_len) random tokens, drawn as the reference's launcher
    draws them."""
    return prompt_batch(cfg, batch, prompt_len, seed, device)["tokens"]


def prompt_batch(cfg, batch: int, prompt_len: int, seed: int, device) -> dict:
    """The model's inputs as the reference's launcher draws them from one
    ``default_rng(seed)``: the tokens, then the vlm's ``image_embeds`` (B,
    N_img, d) or the audio model's ``encoder_embeds`` (B, S_enc, d),
    float32 standard normals times 0.02."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
                                     dtype=torch.int64, device=device)}
    frames = {"vlm": ("image_embeds", cfg.num_image_tokens),
              "audio": ("encoder_embeds", cfg.encoder_seq)}.get(cfg.family)
    if frames is not None:
        name, n = frames
        x = rng.standard_normal((batch, n, cfg.d_model)).astype(np.float32) * np.float32(0.02)
        out[name] = torch.from_numpy(x).to(device)
    return out


def _as_batch(batch) -> dict:
    return batch if isinstance(batch, dict) else {"tokens": batch}


def start_position(cfg, batch) -> int:
    """The position of the first generated token: the prompt's length, and
    the image tokens ahead of it for the vlm."""
    extra = cfg.num_image_tokens if cfg.family == "vlm" else 0
    return _as_batch(batch)["tokens"].shape[1] + extra


def prefill(model: Model, params, batch, max_len: int):
    """The prompt's prefill and its greedy next token: ``batch`` is the
    token tensor or the family's input dict (``prompt_batch``); returns
    (logits of the last position (B, 1, V), cache, token (B, 1))."""
    logits, cache, _aux = model.prefill(params, _as_batch(batch), max_len=max_len)
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


def generate(model: Model, params, batch, gen: int) -> dict:
    """Prefill, then ``gen - 1`` greedy decode steps: the reference
    launcher's loop. ``batch`` is the token tensor or the family's input
    dict. Returns the ``gen`` tokens (B, gen), the prefill's logits and the
    host-clock seconds of prefill and decode."""
    start = start_position(model.cfg, batch)
    _sync(model.device)
    t0 = time.perf_counter()
    logits, cache, tok = prefill(model, params, batch, start + gen)
    _sync(model.device)
    t1 = time.perf_counter()
    rest, _ = decode(model, params, cache, tok, start, gen - 1)
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
    batch = prompt_batch(cfg, b, s, args.seed, model.device)

    with torch.inference_mode():
        res = generate(model, params, batch, args.gen)
    steps = args.gen - 1
    print(f"prefill({b}x{s}) {res['prefill_s']:.2f}s")
    print(f"decoded {steps} steps in {res['decode_s']:.2f}s "
          f"({steps * b / max(res['decode_s'], 1e-9):.1f} tok/s)")
    print("sample:", res["tokens"][0, :16].tolist())


if __name__ == "__main__":
    main()
