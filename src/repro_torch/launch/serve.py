"""Serving launcher: batched prefill + greedy decode with a KV cache (or,
for falcon-mamba, the recurrent SSM state).

    python -m repro_torch.launch.serve --arch gemma2-2b --batch 2 \\
        --prompt-len 4608 --gen 16
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --batch 2 \\
        --prompt-len 4096 --gen 16
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --smoke --device cpu

Runs on the card (``--device cuda``, the default; it raises without one)
through the hand-written kernels; ``--device cpu`` runs the plain PyTorch
versions on the CPU.
Weights are random, from ``--seed``; prompts are random token ids.  Prints
the prefill time, the decode time per step, tokens/s (host clock around work
that ends in ``torch.cuda.synchronize()`` on the card) and the sampled
continuations.  ``--gen`` counts the generated tokens: the prefill's and
``--gen - 1`` decode steps.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch import configs as C
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import params as params_lib
    from repro_torch.models.context import ExecContext
    from repro_torch.runtime.steps import build_serve_steps

    dev = resolve_device(args.device)
    backend = "cuda" if dev.type == "cuda" else "torch"
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    ctx = ExecContext(backend=backend)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = params_lib.init_params(cfg, gen, dev)

    b, s = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).to(dev)}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    prefill_step, decode_step = build_serve_steps(cfg, ctx,
                                                  max_len=s + args.gen,
                                                  temperature=args.temperature)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        tok, caches, length, _ = prefill_step(params, batch, gen)
        sync()
        t_prefill = time.perf_counter() - t0
        out = [tok]
        t1 = time.perf_counter()
        for _ in range(args.gen - 1):
            tok, caches, length, _ = decode_step(params, tok, caches,
                                                  length, gen)
            out.append(tok)
        sync()
        t_decode = time.perf_counter() - t1

    steps = max(args.gen - 1, 1)
    toks = torch.cat(out, dim=1).cpu()
    print(f"{cfg.name} on {dev} ({backend}): prefill {b}x{s} tokens in "
          f"{t_prefill * 1e3:.1f} ms ({b * s / t_prefill:.0f} tokens/s)")
    print(f"decode: {args.gen - 1} steps in {t_decode * 1e3:.1f} ms "
          f"({t_decode / steps * 1e3:.2f} ms/step, "
          f"{b * (args.gen - 1) / max(t_decode, 1e-9):.1f} tokens/s)")
    print("sample continuations (token ids):")
    for r in range(min(b, 4)):
        print(f"  req{r}: {toks[r][:16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
