"""Serve a small model with batched requests on the PyTorch port (twin of
``serve_batch.py``): prefill a batch of prompts, then decode tokens with
the KV/state cache, any of the 10 architectures in its reduced form.

It runs the port's launcher, ``python -m repro_torch.launch.serve``, the
way an operator would, on ``--device`` (default: the card, where the
launcher raises without one). On the card the prefill's attention is the
hand-written kernel, which takes head dims 64, 80 and 128: the reduced
``whisper-small`` (32) serves on the CPU only.

  PYTHONPATH=src python examples/torch_serve_batch.py --arch rwkv6-7b --gen 12 [--device cpu]
"""

import argparse
import subprocess
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    # the serving loop lives in the launcher; this example drives it the way
    # an operator would
    cmd = [
        sys.executable, "-m", "repro_torch.launch.serve",
        "--arch", args.arch, "--reduced",
        "--batch", str(args.batch),
        "--prompt-len", str(args.prompt_len),
        "--gen", str(args.gen),
    ] + ([] if args.device is None else ["--device", args.device])
    proc = subprocess.run(cmd, capture_output=True, text=True)
    print(proc.stdout, end="")
    print(proc.stderr, end="", file=sys.stderr)
    return {"returncode": proc.returncode, "stdout": proc.stdout}


if __name__ == "__main__":
    raise SystemExit(main()["returncode"])
