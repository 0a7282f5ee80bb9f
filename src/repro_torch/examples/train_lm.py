"""End-to-end LM training driver on the synthetic bigram stream.

Port of the top-level ``examples/train_lm.py``: data pipeline → train
step (gradient accumulation, layer remat) → AdamW → async checkpointing
→ restart, for a configurable model size.  The synthetic stream has
~log2(8) = 3 bits/token of structure, so cross-entropy falls from ln(V)
toward ~ln(8) as the model learns the bigram table: a real loss curve,
not noise.

Defaults are the ~22M-parameter preset, 300 steps; ``--preset 100m``
selects the ~100M-parameter config (the same code path).  Checkpoints
(the port's ``Trainer`` format) go to ``--ckpt-dir``, a directory under
the temporary one by default, where ``serve_lm`` finds them; a second run
on the same directory resumes from its newest checkpoint.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
      [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import os
import tempfile

PRESETS = {
    # ~22M params: the CPU-budget demo (d=384, 6L)
    "22m": dict(d_model=384, n_layers=6, n_heads=6, d_ff=1536, vocab=8192,
                seq=128, batch=16),
    # ~100M params: the end-to-end scale on a device
    "100m": dict(d_model=768, n_layers=12, n_heads=12, d_ff=3072,
                 vocab=32768, seq=512, batch=32),
}


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")


def lm_config(preset: str):
    """The preset's model: global attention layers, MHA, SwiGLU."""
    from repro_torch.models.config import AttnConfig, ModelConfig, repeat_program
    p = PRESETS[preset]
    return ModelConfig(
        name=f"lm-{preset}", d_model=p["d_model"], n_layers=p["n_layers"],
        vocab_size=p["vocab"], d_ff=p["d_ff"],
        layer_program=repeat_program(("attn",), p["n_layers"]),
        attn=AttnConfig(n_heads=p["n_heads"], n_kv_heads=p["n_heads"],
                        head_dim=p["d_model"] // p["n_heads"]))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="22m", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=default_ckpt_dir())
    ap.add_argument("--quant-moments", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default; it raises without "
                         "one) or 'cpu' (the kernels' plain versions)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """Train as ``args`` say; returns (trainer, metrics history).  Raises
    ``RuntimeError`` if the loss did not fall."""
    from repro_torch.data import SyntheticConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig, TrainHParams

    p = PRESETS[args.preset]
    cfg = lm_config(args.preset)
    print(f"[train_lm] {cfg.name}: {cfg.num_params()/1e6:.1f}M params, "
          f"seq {p['seq']}, global batch {p['batch']}")
    data = SyntheticConfig(vocab_size=p["vocab"], seq_len=p["seq"],
                           global_batch=p["batch"], seed=0, branching=8)
    hp = TrainHParams(peak_lr=args.lr, warmup_steps=40,
                      total_steps=args.steps, grad_accum=args.grad_accum)
    opt = AdamWConfig(quantize_moments=args.quant_moments)
    tc = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=10,
                       hb_dir=os.path.join(args.ckpt_dir, "hb"))
    trainer = Trainer(cfg, None, data, opt, hp, tc, device=args.device)
    hist = trainer.run(args.steps)

    first = hist[0]["loss"] if hist else float("nan")
    last = hist[-1]["loss"] if hist else float("nan")
    print(f"\n[train_lm] loss {first:.3f} → {last:.3f} "
          f"(uniform={math.log(p['vocab']):.3f}, "
          f"bigram floor≈{math.log(8):.3f})")
    if not last < first:
        raise RuntimeError("loss did not decrease")
    print("[train_lm] loss curve (step, ce):")
    for h in hist:
        print(f"  {h['step']:>5} {h['loss']:.4f}")
    return trainer, hist


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
