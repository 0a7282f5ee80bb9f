"""Batched serving driver: prefill + decode over a request batch.

Port of the top-level ``examples/serve_lm.py``: several requests with a
shared decode budget run through prefill (cache build), then token-by-token
batched decode with greedy or temperature sampling, through the serve
steps of ``runtime/steps.py``.

Uses the model ``train_lm`` trained when its checkpoint is under
``--ckpt-dir`` (so the continuations follow the synthetic bigram table,
which the last lines count: the generated tokens that follow it, and the
probability the served logits put on the table's successors of each
step's previous token), otherwise random weights.  ``--preset`` names
``train_lm``'s preset (the reference serves its 22m preset only).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--gen 32]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.examples.train_lm import PRESETS, default_ckpt_dir, lm_config


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--preset", default="22m", choices=list(PRESETS))
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default; it raises without "
                         "one) or 'cpu' (the kernels' plain versions)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Serve as ``args`` say; returns ``{"trained", "step", "ok",
    "total", "chance", "mass", "mass_se", "prefill_ms", "decode_ms"}``:
    ``ok`` of ``total`` generated tokens follow the bigram table from
    their predecessor; ``mass`` is the mean over the ``total`` steps of
    the probability the step's logits put on the predecessor's successors
    (``chance`` under uniform logits), ``mass_se`` its standard error."""
    import torch
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.data import SyntheticConfig, batch_for_step
    from repro_torch.data.synthetic import _successor_table
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import params as params_lib
    from repro_torch.models.context import ExecContext
    from repro_torch.runtime.steps import build_serve_steps

    dev = resolve_device(args.device)
    p = PRESETS[args.preset]
    cfg = lm_config(args.preset)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = params_lib.init_params(cfg, gen, dev)

    trained, step = False, None
    if latest_step(args.ckpt_dir) is not None:
        try:
            got, _, step = restore_checkpoint(args.ckpt_dir, {"params": params},
                                              device=dev)
            params = got["params"]
            trained = True
            print(f"[serve_lm] restored trained weights (step {step})")
        except (KeyError, OSError) as e:
            print(f"[serve_lm] checkpoint restore skipped ({e}); "
                  "using random weights")

    data = SyntheticConfig(vocab_size=p["vocab"], seq_len=args.prompt_len,
                           global_batch=args.batch, seed=0, branching=8)
    prompts = batch_for_step(data, step=10_001)   # unseen step → fresh data
    batch = {"tokens": torch.from_numpy(
        prompts["tokens"].astype(np.int64)).to(dev)}

    ctx = ExecContext(backend="cuda" if dev.type == "cuda" else "torch")
    prefill_step, decode_step = build_serve_steps(
        cfg, ctx, max_len=args.prompt_len + args.gen,
        temperature=args.temperature)
    sample_gen = torch.Generator(device=dev).manual_seed(1)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        tok, caches, length, logits = prefill_step(params, batch, sample_gen)
        sync()
        t_prefill = time.perf_counter() - t0
        print(f"[serve_lm] prefill {args.batch}×{args.prompt_len} tokens: "
              f"{t_prefill*1e3:.0f} ms "
              f"({args.batch*args.prompt_len/t_prefill:.0f} tok/s)")
        outs, probs = [tok], [torch.softmax(logits[:, -1].float(), -1)]
        t1 = time.perf_counter()
        for _ in range(args.gen - 1):
            tok, caches, length, logits = decode_step(params, tok, caches,
                                                      length, sample_gen)
            outs.append(tok)
            probs.append(torch.softmax(logits[:, -1].float(), -1))
        sync()
        t_dec = time.perf_counter() - t1
    steps = max(args.gen - 1, 1)
    print(f"[serve_lm] decode {args.gen-1} steps × {args.batch} reqs: "
          f"{t_dec*1e3:.0f} ms "
          f"({(args.gen-1)*args.batch/t_dec:.0f} tok/s, "
          f"{t_dec/steps*1e3:.1f} ms/step)")
    gen_toks = torch.cat(outs, dim=1).cpu().numpy()
    probs = torch.stack(probs, 1).cpu().numpy()            # (B, gen, V)

    # the continuations against the bigram table
    table = _successor_table(data)
    ok = total = 0
    masses = []
    for r in range(args.batch):
        prev = prompts["tokens"][r, -1]
        for t in range(args.gen):
            total += 1
            if gen_toks[r, t] in table[prev]:
                ok += 1
            masses.append(float(probs[r, t, table[prev]].sum()))
            prev = gen_toks[r, t]
    chance = 8 / p["vocab"]
    mass = float(np.mean(masses))
    mass_se = float(np.std(masses, ddof=1) / np.sqrt(len(masses)))
    lift = (ok / total) / chance if total else 0.0
    print(f"[serve_lm] continuations following the bigram table: "
          f"{ok}/{total} ({ok/total:.1%}; chance {chance:.2%} → "
          f"{lift:.0f}× lift)"
          + ("" if trained else "  (random weights)"))
    print(f"[serve_lm] probability on the bigram table's successors: "
          f"{mass:.3e} ± {mass_se:.1e} (chance {chance:.3e} → "
          f"{mass / chance:.3f}× lift)")
    for r in range(min(3, args.batch)):
        print(f"  req{r}: ...{prompts['tokens'][r, -4:].tolist()} → "
              f"{gen_toks[r, :10].tolist()}")
    return {"trained": trained, "step": step, "ok": ok, "total": total,
            "chance": chance, "mass": mass, "mass_se": mass_se,
            "prefill_ms": t_prefill * 1e3,
            "decode_ms": t_dec * 1e3}


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
