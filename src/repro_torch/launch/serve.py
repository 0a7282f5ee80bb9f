"""Serving launcher: batched prefill + greedy decode with a KV cache (or,
for falcon-mamba, the recurrent SSM state).

    python -m repro_torch.launch.serve --arch gemma2-2b --batch 2 \\
        --prompt-len 4608 --gen 16
    python -m repro_torch.launch.serve --arch falcon-mamba-7b --batch 2 \\
        --prompt-len 4096 --gen 16
    python -m repro_torch.launch.serve --arch gemma3-27b --layers 12 \\
        --batch 2 --prompt-len 4096 --gen 16
    python -m repro_torch.launch.serve --arch qwen2-vl-2b --smoke --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v3-671b --layers 4 \\
        --batch 2 --prompt-len 4096 --gen 16
    python -m repro_torch.launch.serve --arch whisper-medium --batch 4 \\
        --prompt-len 432 --gen 16

Runs on the card (``--device cuda``, the default; it raises without one)
through the hand-written kernels; ``--device cpu`` runs the plain PyTorch
versions on the CPU.
Weights are random, from ``--seed``; prompts are random token ids.  Prints
the prefill time, the decode time per step, tokens/s (host clock around work
that ends in ``torch.cuda.synchronize()`` on the card) and the sampled
continuations.  ``--gen`` counts the generated tokens: the prefill's and
``--gen - 1`` decode steps.  ``--layers N`` keeps the first N layers at
full width (gemma3-27b's 62 float32 layers exceed one card; deepseek-v3's
first 4 are 60.4 GB).  A config's multi-token prediction modules are not
built: serving never reads them (11.6e9 parameters at deepseek's 4-layer
cut, whose MTP block is an ``attn_moe`` one).  As in the
reference's launcher, an encoder–decoder model (whisper) gets random audio
frames ``(batch, n_frames, d)``, the vision stub (qwen2-vl) 8 random
patches in the first ``min(4, prompt)`` slots, and M-RoPE's three position
rows are each ``arange(prompt)``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def stub_inputs(cfg, b: int, s: int, rng, device) -> dict:
    """The reference launcher's extra inputs for ``b`` prompts of ``s``
    tokens, drawn from ``rng`` in its order: for an encoder–decoder model
    ``audio_embed``, ``(b, n_frames, d)`` standard normal frames; for the
    vision stub 8 random patches in the first ``min(4, s)`` slots; for
    M-RoPE each of the three position rows ``arange(s)``."""
    import numpy as np
    import torch
    out = {}
    if cfg.is_encdec:
        out["audio_embed"] = torch.from_numpy(rng.normal(
            size=(b, cfg.encoder.n_frames, cfg.d_model)).astype(
                np.float32)).to(device)
    if cfg.vision_stub:
        slot = -np.ones((b, s), np.int64)
        slot[:, :min(4, s)] = np.arange(min(4, s))
        out["vision_embed"] = torch.from_numpy(rng.normal(
            size=(b, 8, cfg.d_model)).astype(np.float32)).to(device)
        out["vision_slot"] = torch.from_numpy(slot).to(device)
    if cfg.pos_embed == "mrope":
        out["positions3"] = torch.arange(s, device=device)[None, None].repeat(
            3, b, 1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (0: all)")
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
    if args.layers:
        cfg = C.first_layers(cfg, args.layers)
    cfg = dataclasses.replace(cfg, mtp_depth=0)
    ctx = ExecContext(backend=backend)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = params_lib.init_params(cfg, gen, dev)

    b, s = args.batch, args.prompt_len
    rng = np.random.default_rng(args.seed)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s))).to(dev)}
    batch.update(stub_inputs(cfg, b, s, rng, dev))

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
