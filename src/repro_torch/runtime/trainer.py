"""The fault-tolerant training loop on one device.  Port of
``repro/runtime/trainer.py``::

    params/opt init (or restore) → train step → loop:
        heartbeat · straggler monitor · periodic async checkpoint
    → on failure: the restart loop reloads the newest checkpoint and
      continues from the same data position (stateless loader).

The Trainer is process-shaped (no globals): tests drive it with tiny
configs, inject failures, kill and resurrect it, and check bit-exact
continuation.  Sharded and FSDP training (the reference's ``mesh``) wait
for ROADMAP A7.7.  ``TrainerConfig.param_dtype`` is ``"float32"`` (the
default) or ``"bfloat16"``: the parameters' dtype, the moments float32
either way.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step
from repro_torch.data import SyntheticConfig, make_batch_loader
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import params as params_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.context import ExecContext
from repro_torch.optim import AdamWConfig, adamw_init

from .monitor import Heartbeat, PeerFailure, StragglerMonitor
from .steps import TrainHParams, build_train_step


@dataclass
class TrainerConfig:
    """``ckpt_every``: steps between checkpoints; 0 writes none (neither
    periodic nor final).  ``param_dtype``: one of :data:`PARAM_DTYPES`."""
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    hb_dir: Optional[str] = None
    hb_timeout_s: float = 60.0
    log_every: int = 10
    seed: int = 0
    param_dtype: str = "float32"
    max_restarts: int = 3
    log: Callable[[str], None] = print


#: the parameter dtypes the trainer builds, by ``TrainerConfig.param_dtype``
PARAM_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Trainer:
    """``mesh`` must be ``None`` (one device).  ``ctx`` defaults to
    ``ExecContext(backend="cuda", remat="block")``: the hand-written
    kernels, with their gradients, and layer remat.  ``device`` defaults
    to the card and raises without one; on the CPU the kernels' plain
    versions run.  ``metrics_history`` gets ``{"step", "loss", "ce",
    "mtp"?, "grad_norm", "lr", "ms"}`` every ``log_every`` steps (``mtp``
    under multi-token prediction) (``ms``: the step's wall time,
    to the host's read of its loss)."""

    def __init__(self, cfg: ModelConfig, mesh, data_cfg: SyntheticConfig,
                 opt_cfg: AdamWConfig, hp: TrainHParams, tc: TrainerConfig,
                 *, ctx: Optional[ExecContext] = None, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): sharded and FSDP training are not ported "
                "yet (ROADMAP A7.7); pass mesh=None for one device")
        if tc.param_dtype not in PARAM_DTYPES:
            raise ValueError(f"param_dtype must be one of "
                             f"{sorted(PARAM_DTYPES)}, got {tc.param_dtype!r}")
        self.cfg = cfg
        self.mesh = None
        self.data_cfg = data_cfg
        self.opt_cfg = opt_cfg
        self.hp = hp
        self.tc = tc
        self.device = resolve_device(device)
        self.ctx = ctx or ExecContext(backend="cuda", remat="block")

        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=tc.keep)
        self.hb = (Heartbeat(tc.hb_dir, host_id=0,
                             timeout_s=tc.hb_timeout_s)
                   if tc.hb_dir else None)
        self.monitor = StragglerMonitor(log=tc.log)
        self.metrics_history: list[dict] = []

        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        gen = torch.Generator(device=self.device).manual_seed(self.tc.seed)
        self.params = params_lib.trainable(params_lib.init_params(
            self.cfg, gen, self.device, PARAM_DTYPES[self.tc.param_dtype]))
        self.opt_state = adamw_init(self.params, self.opt_cfg)
        self.step = 0
        self.loader = make_batch_loader(self.data_cfg, device=self.device)
        self._step = build_train_step(self.cfg, self.ctx, self.opt_cfg,
                                      self.hp)

    # ------------------------------------------------------------------
    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self, blocking: bool = False):
        self.ckpt.save(self.step, self._state_tree(),
                       extra={"step": self.step,
                              "arch": self.cfg.name,
                              "data_seed": self.data_cfg.seed},
                       blocking=blocking)

    def restore_latest(self) -> bool:
        """Loads the newest checkpoint onto this trainer's device.  Returns
        True if one was found; raises ``ValueError`` if it was written for
        another architecture or data seed."""
        if latest_step(self.tc.ckpt_dir) is None:
            return False
        tree, extra, step = self.ckpt.restore_latest(self._state_tree(),
                                                     device=self.device)
        mine = {"arch": self.cfg.name, "data_seed": self.data_cfg.seed}
        theirs = {k: extra.get(k) for k in mine}
        if theirs != mine:
            raise ValueError(
                f"the checkpoint under {self.tc.ckpt_dir} is of {theirs}, "
                f"this trainer of {mine}; use another ckpt_dir")
        self.params = params_lib.trainable(tree["params"])
        self.opt_state = tree["opt"]
        self.step = int(extra.get("step", step))
        self.tc.log(f"[trainer] restored step {self.step} from checkpoint")
        return True

    # ------------------------------------------------------------------
    def train_steps(self, n: int, *, failure_hook: Optional[Callable] = None):
        """Run ``n`` steps from the current position (one restart body)."""
        for _ in range(n):
            batch = self.loader(self.step)
            t0 = time.monotonic()
            self.params, self.opt_state, metrics = self._step(
                self.params, self.opt_state, batch)
            m = {k: float(v) for k, v in metrics.items()}   # waits for it
            dt = time.monotonic() - t0
            self.step += 1
            self.monitor.record(self.step, dt)
            if self.hb:
                self.hb.beat(self.step)
                self.hb.check()
            if self.step % self.tc.log_every == 0:
                self.metrics_history.append(
                    {"step": self.step, **m, "ms": dt * 1e3})
                self.tc.log(f"[trainer] step {self.step} "
                            f"loss {m['loss']:.4f} "
                            f"gnorm {m['grad_norm']:.3f} {dt*1e3:.0f} ms")
            if self.tc.ckpt_every > 0 and self.step % self.tc.ckpt_every == 0:
                self.save()
            if failure_hook is not None:
                failure_hook(self)
        self.ckpt.wait()

    def run(self, total_steps: int, **kw):
        """Restart loop: survive PeerFailure by reloading the newest
        checkpoint and continuing."""
        self.restore_latest()
        restarts = 0
        while self.step < total_steps:
            try:
                self.train_steps(total_steps - self.step, **kw)
            except PeerFailure as e:
                restarts += 1
                self.tc.log(f"[trainer] {e}; restart {restarts}")
                if restarts > self.tc.max_restarts:
                    raise
                self.ckpt.wait()
                if not self.restore_latest():
                    self.tc.log("[trainer] no checkpoint; restarting fresh")
        if self.tc.ckpt_every > 0:
            self.save(blocking=True)
        return self.metrics_history
