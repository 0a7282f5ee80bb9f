"""Failure detection and straggler mitigation.  The port's own copy of
``repro/runtime/monitor.py``; the heartbeat files keep the reference's
JSON format (``{"t": clock, "step": n}`` in ``host_<id:05d>.hb``).

* :class:`Heartbeat` — each host touches ``<dir>/host_<id>.hb`` with a
  monotonic timestamp and its step; ``dead_peers()`` reports hosts whose
  file is stale.  The trainer polls it between steps and raises
  :class:`PeerFailure` so the restart loop reloads the newest checkpoint.
* :class:`StragglerMonitor` — per-step wall-time EWMA; a step slower than
  ``threshold × EWMA`` is flagged and logged (with one host the
  rebalancing hook only logs its decision).

Nothing here touches a device.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class PeerFailure(RuntimeError):
    def __init__(self, dead: list[str]):
        super().__init__(f"dead peers: {dead}")
        self.dead = dead


class Heartbeat:
    def __init__(self, directory: str, host_id: int, *,
                 timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.dir = directory
        self.host_id = host_id
        self.timeout_s = timeout_s
        self.clock = clock
        os.makedirs(directory, exist_ok=True)

    def _path(self, host_id: int) -> str:
        return os.path.join(self.dir, f"host_{host_id:05d}.hb")

    def beat(self, step: int):
        tmp = self._path(self.host_id) + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"t": self.clock(), "step": step}, f)
        os.replace(tmp, self._path(self.host_id))

    def peers(self) -> dict[int, dict]:
        out = {}
        for fn in os.listdir(self.dir):
            if fn.startswith("host_") and fn.endswith(".hb"):
                try:
                    with open(os.path.join(self.dir, fn)) as f:
                        out[int(fn[5:10])] = json.load(f)
                except (OSError, json.JSONDecodeError, ValueError):
                    continue
        return out

    def dead_peers(self) -> list[int]:
        now = self.clock()
        return sorted(h for h, rec in self.peers().items()
                      if now - rec["t"] > self.timeout_s)

    def check(self):
        dead = self.dead_peers()
        if dead:
            raise PeerFailure([f"host_{h:05d}" for h in dead])


@dataclass
class StragglerMonitor:
    """EWMA step-time tracker with slow-step flagging."""
    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3                 # first steps include compile; skip them
    ewma: Optional[float] = None
    count: int = 0
    flagged: list = field(default_factory=list)
    log: Callable[[str], None] = print

    def record(self, step: int, dt: float) -> bool:
        """Returns True if the step was flagged as a straggler."""
        self.count += 1
        if self.count <= self.warmup:
            return False
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.flagged.append((step, dt, self.ewma))
            self.log(f"[straggler] step {step}: {dt*1e3:.1f} ms vs EWMA "
                     f"{self.ewma*1e3:.1f} ms — rebalance hook engaged")
            # mitigation hook: at scale, shift microbatch rows away from
            # the slow host next step; single-host runs only log.
        else:
            self.ewma = self.alpha * dt + (1 - self.alpha) * self.ewma
        return slow
