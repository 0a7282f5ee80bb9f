"""Training launcher (one device).

    # on the card: gemma2-2b at full width and depth
    python -m repro_torch.launch.train --arch gemma2-2b --steps 6 \\
        --seq-len 256 --global-batch 8 --grad-accum 2
    # the reduced config on the CPU (the kernels' plain versions)
    python -m repro_torch.launch.train --arch gemma2-2b --smoke --device cpu
    # gemma3-27b at full width, one 5:1 group, 8-bit moments
    python -m repro_torch.launch.train --arch gemma3-27b --layers 6 \\
        --quant-moments --steps 3 --seq-len 256 --global-batch 8 \\
        --grad-accum 2 --ckpt-every 0
    # deepseek-v3-671b at full width, 3 layers and its MTP block
    python -m repro_torch.launch.train --arch deepseek-v3-671b --layers 3 \\
        --quant-moments --steps 3 --seq-len 256 --global-batch 8 \\
        --grad-accum 2 --ckpt-every 0

The reference's flags (``repro/launch/train.py``) plus ``--device``
(default the card; it raises without one), ``--backend`` (``cuda``, the
hand-written kernels, or ``torch``, the plain versions), ``--log-every``,
``--layers N`` (the first N layers at full width; a config's multi-token
prediction modules stay, their block the cut program's last type) and
``--ckpt-every 0``
(no checkpoint at all: gemma2-2b's final one is 31 GB of parameters and
moments).  Checkpoints go to a fresh directory
under the temporary directory unless ``--ckpt-dir`` names one; a run
resumes only from a directory it is given, and only a checkpoint of its
own ``--arch`` and ``--seed`` (``Trainer.restore_latest`` raises on
another).  ``--mesh`` other than
``none`` and ``--compress-pod`` raise ``NotImplementedError`` (sharded
training, ROADMAP A7.7).  An encoder–decoder arch (whisper-medium) raises
``ValueError``: the synthetic stream carries no ``audio_embed`` (the
reference's launcher dies on it with a ``KeyError``); train it through
``runtime.steps.build_train_step`` on batches that carry frames.  Weights are random from ``--seed``; the data is
the synthetic successor stream (``repro_torch.data``), whose loss falls.
The restart loop is inside ``Trainer.run``: it reloads the newest
checkpoint and resumes from the same step of the stateless stream.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers (0: all)")
    ap.add_argument("--mesh", default="none",
                    choices=("none", "single", "multi", "test"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new directory under the temporary one")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--quant-moments", action="store_true")
    ap.add_argument("--compress-pod", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="cuda", choices=("cuda", "torch"))
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def train(args: argparse.Namespace):
    """Build the trainer ``args`` describe and run it; returns (trainer,
    metrics history)."""
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: sharded training is not ported yet "
            f"(ROADMAP A7.7)")
    from repro_torch import configs as C
    from repro_torch.data import SyntheticConfig
    from repro_torch.models.context import ExecContext
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig, TrainHParams

    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    if cfg.is_encdec:
        raise ValueError(
            f"{cfg.name}: an encoder-decoder model trains on batches with "
            f"'audio_embed' frames, and the synthetic token stream carries "
            f"none; build the step with runtime.steps.build_train_step and "
            f"feed it such batches")
    if args.layers:
        cfg = C.first_layers(cfg, args.layers)
    data = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                           global_batch=args.global_batch, seed=args.seed)
    hp = TrainHParams(peak_lr=args.peak_lr, warmup_steps=args.warmup,
                      total_steps=args.steps, grad_accum=args.grad_accum,
                      compress_pod=args.compress_pod)
    opt = AdamWConfig(quantize_moments=args.quant_moments)
    ckpt_dir = args.ckpt_dir
    if ckpt_dir is None:
        ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        print(f"checkpoints under {ckpt_dir}")
    tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
                       hb_dir=os.path.join(ckpt_dir, "hb"), seed=args.seed,
                       log_every=args.log_every)
    trainer = Trainer(cfg, None, data, opt, hp, tc, device=args.device,
                      ctx=ExecContext(backend=args.backend, remat="block"))
    return trainer, trainer.run(args.steps)


def main(argv=None):
    _, hist = train(parse_args(argv))
    if hist:
        print(f"final loss {hist[-1]['loss']:.4f} at step {hist[-1]['step']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
