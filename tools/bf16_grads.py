"""Step 1's bfloat16 gradients of one family on the card, leaf by leaf, by
route: how far each source of rounding moves them.

    python3 tools/bf16_grads.py [--arch zamba2-2.7b] [--layers N]
        [--out chiprun_out/bf16_grads_<arch>.json]
    python3 tools/bf16_grads.py --smoke --device cpu   # a rehearsal

Builds the family from seeded bfloat16 weights (``init_params(...,
dtype=torch.bfloat16)``; ``--layers`` cuts it to its first N layers) and
takes the first training batch of ``chip_smoke.py``'s phase 16 (8 × 256
tokens of the successor stream, seed 0, one microbatch; whisper 8 × 448
tokens in two, with 8 × 1500 random frames), then computes the loss and
its gradient the way the train step does (block remat) on these routes:

* ``cuda``: the kernels (kernels 2a and 4);
* ``torch``: the plain path, the route every other is held to;
* ``torch_again``: the plain path once more (is it reproducible?);
* ``rms_only`` / ``gated_only`` / ``flash_only``: the kernels' route with
  the other kernels' plain versions;
* ``torch_rounded_norms``: the plain path with every norm's output
  computed in float64 and rounded once (``chip_smoke.rounded_rmsnorm``,
  ``rounded_layernorm``): phase 16's per-leaf floor;
* ``torch_chunked``: the plain path on the chunked attention oracle (128
  query rows at a time): another float32 order of the same sums;
* ``torch_float32``: the same weights upcast to float32 on the plain path:
  how far bfloat16 itself moves each leaf.

For each route against ``torch`` it prints one JSON line: the loss's and
the global gradient norm's relative differences, the worst and median
relative difference of the leaves' gradient norms, and the worst leaves.
TF32 stays off for the matrix products, as in ``chip_smoke.py``.
``--smoke --device cpu`` runs the reduced config on 4 × 12 tokens on the
CPU, where every route but the rounded and float32 ones is the plain path
but for kernel 4's backward: a rehearsal.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUTES = ("cuda", "torch", "torch_again", "rms_only", "gated_only",
          "flash_only", "torch_rounded_norms", "torch_chunked",
          "torch_float32")
OPS = {"rms_only": "rmsnorm", "gated_only": "gated_act",
       "flash_only": "flash_attention"}


def leaf_items(tree, prefix=""):
    """(path, tensor) of ``tree``'s leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_items(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_items(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@contextlib.contextmanager
def patched(route, ops):
    """The ops module's entry points as ``route`` wants them: under
    ``*_only`` every other kernel's entry point on its plain version; under
    ``torch_rounded_norms`` the norms rounded once from float64."""
    saved = {n: getattr(ops, n) for n in OPS.values()}
    with contextlib.ExitStack() as stack:
        if route in OPS:
            for name, f in saved.items():
                if name != OPS[route]:
                    setattr(ops, name, lambda *a, f=f, **kw: f(
                        *a, **{**kw, "target": "torch"}))
        elif route == "torch_rounded_norms":
            sys.path.insert(0, str(ROOT))
            import chip_smoke
            stack.enter_context(chip_smoke.rounded_rmsnorm())
            stack.enter_context(chip_smoke.rounded_layernorm())
        try:
            yield
        finally:
            for name, f in saved.items():
                setattr(ops, name, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bf16_grads: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.data import SyntheticConfig, make_batch_loader
    from repro_torch.kernels import ops
    from repro_torch.models import params as model_params
    from repro_torch.models.context import ExecContext
    from repro_torch.runtime.steps import TrainHParams, _metrics_and_grads

    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip(),
              flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    cfg = (configs.get_smoke if args.smoke else configs.get_config)(args.arch)
    if args.layers:
        cfg = configs.first_layers(cfg, args.layers)
    seq, accum = (448, 2) if cfg.is_encdec else (256, 1)
    b, s = (4, 12) if args.smoke else (8, seq)
    params = model_params.trainable(model_params.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev,
        torch.bfloat16))
    batch = make_batch_loader(SyntheticConfig(cfg.vocab_size, s, b, seed=0),
                              device=dev)(0)
    if cfg.is_encdec:
        batch["audio_embed"] = torch.randn(
            b, cfg.encoder.n_frames, cfg.d_model, device=dev,
            generator=torch.Generator(device=dev).manual_seed(1000))
    hp = TrainHParams(grad_accum=accum)
    runs = {}
    for route in ROUTES:
        backend = "torch" if route.startswith("torch") else "cuda"
        impl = "chunked" if route == "torch_chunked" else "ref"
        fn = _metrics_and_grads(cfg, ExecContext(
            backend=backend, remat="block", attn_impl=impl), hp)
        p = params
        if route == "torch_float32":
            p = torch.utils._pytree.tree_map(
                lambda t: t.detach().float().requires_grad_(t.requires_grad),
                params)
        with patched(route, ops):
            metrics, grads = fn(p, batch)
        items = list(leaf_items(grads))
        runs[route] = {"loss": float(metrics["loss"]),
                       "names": [n for n, _ in items],
                       "norms": torch.stack([torch.linalg.vector_norm(
                           g.float()) for _, g in items]).tolist()}
        del grads, items, p
        if args.device == "cuda":
            torch.cuda.empty_cache()
    base = runs["torch"]

    def global_norm(r):
        return sum(x * x for x in r["norms"]) ** 0.5

    out = {"arch": cfg.name, "layers": cfg.n_layers, "batch": [b, s],
           "accum": accum}
    for route in ROUTES:
        if route == "torch":
            continue
        r = runs[route]
        rel = [abs(x - y) / y if y else abs(x)
               for x, y in zip(r["norms"], base["norms"])]
        worst = sorted(range(len(rel)), key=lambda i: -rel[i])[:8]
        out[route] = {
            "loss_rel_diff": abs(r["loss"] - base["loss"]) / base["loss"],
            "grad_norm_rel_diff": abs(global_norm(r) - global_norm(base))
            / global_norm(base),
            "leaf_rel_diff_worst": max(rel),
            "leaf_rel_diff_median": statistics.median(rel),
            "leaves_over_3e-3": sum(x > 3e-3 for x in rel),
            "worst_leaves": [{"leaf": base["names"][i], "rel_diff": rel[i],
                              "norm": base["norms"][i]} for i in worst]}
        print(json.dumps({route: out[route]}), flush=True)
    out["losses"] = {k: v["loss"] for k, v in runs.items()}
    out["global_norms"] = {k: global_norm(v) for k, v in runs.items()}
    print(json.dumps({"global_norms": out["global_norms"]}), flush=True)
    path = pathlib.Path(args.out or ROOT / "chiprun_out"
                        / f"bf16_grads_{cfg.name}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
