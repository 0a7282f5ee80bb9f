"""``tdp.faults`` — deterministic fault injection for chaos testing.

A resilience claim is only as good as the faults it was proven against.
These injectors cover the failures a long-running fleet service sees, each
scheduled explicitly (raise on the k-th launch, poison at member step s,
damage checkpoint step n), so a chaos test is a **seeded schedule**, not a
dice roll:

* :func:`register_failing_executor` — an executor that delegates to a real
  one but raises :class:`InjectedFault` on scheduled invocations.  The
  reference's executors run when a launch is *traced*, so its schedule
  counts compiles; the port's run at every launch, so ``fail_on`` counts
  **launches** (an ensemble launch is one) — a difference of definition
  (ROADMAP §C).
* :func:`nan_at_step` / :func:`raise_in_pump` — chaos hooks for
  :meth:`FleetDriver.inject`: poison one ticket's live state once it
  reaches a step (the silent-divergence failure), or blow up the pump loop
  itself (the pump-thread crash the driver must surface, not swallow).
* :func:`kill_pump_thread` — abrupt shutdown: stops the background thread
  without the graceful final checkpoint flush, for kill-and-restore tests.
* :func:`corrupt_checkpoint` — byte-flip / truncate / manifest-damage a
  written snapshot, for restore-fallback tests.

Everything here reaches into driver internals on purpose; it ships in the
library so operators can rehearse failure drills against their own
programs, but nothing in the serving path imports it.
"""
from __future__ import annotations

import os

import numpy as np

from .registry import get_executor_entry, register_executor, \
    unregister_executor

__all__ = [
    "InjectedFault",
    "register_failing_executor",
    "unregister_failing_executor",
    "nan_at_step",
    "raise_in_pump",
    "kill_pump_thread",
    "corrupt_checkpoint",
]


class InjectedFault(RuntimeError):
    """The marker exception every injector raises — chaos tests assert on
    this type to be sure they caught *their* fault, not a real bug."""


class _FailingExecutor:
    """Callable executor delegating to ``base`` except on scheduled
    invocations (see :func:`register_failing_executor`)."""

    def __init__(self, name: str, base_fn, fail_on: int, times: float):
        self.name = name
        self._base = base_fn
        self.fail_on = int(fail_on)
        self.times = times          # float("inf") = persistent
        self.calls = 0

    def __call__(self, plan, arrays, out=None):
        self.calls += 1
        if self.fail_on <= self.calls < self.fail_on + self.times:
            raise InjectedFault(
                f"injected executor fault: call {self.calls} of executor "
                f"{self.name!r} (schedule: fail_on={self.fail_on}, "
                f"times={self.times})")
        return self._base(plan, arrays, out)


def register_failing_executor(name: str, *, base: str = "torch",
                              fail_on: int = 1,
                              times: float = 1) -> _FailingExecutor:
    """Register executor ``name``: behaves exactly like ``base`` (its
    capabilities included) but raises :class:`InjectedFault` on launches
    ``fail_on .. fail_on+times-1`` (1-based; ``times=float("inf")`` never
    recovers).  Every launch invokes the executor (an ensemble launch
    once), so ``fail_on=1`` faults the first launch routed here.  Returns
    the handle (``.calls`` counts invocations); call
    :func:`unregister_failing_executor` to clean up."""
    if fail_on < 1:
        raise ValueError(f"fail_on is a 1-based call index, got {fail_on}")
    if not times >= 1:
        raise ValueError(f"times must be >= 1 (or inf), got {times}")
    entry = get_executor_entry(base)
    handle = _FailingExecutor(name, entry.fn, fail_on, times)
    register_executor(name, handle, overwrite=True, wants=entry.wants,
                      tunables=entry.tunables, vvls=entry.vvls,
                      takes_fields=entry.takes_fields,
                      smem_bytes=entry.smem_bytes,
                      takes_ensemble=entry.takes_ensemble)
    return handle


def unregister_failing_executor(name: str) -> None:
    unregister_executor(name)


# ---------------------------------------------------------------------------
# driver chaos hooks (FleetDriver.inject)
# ---------------------------------------------------------------------------
# A hook is ``fn(driver) -> bool`` run under the driver lock at the top of
# every pump round; returning True retires the hook.

def nan_at_step(ticket_id: str, field: str, at_step: int, *,
                value: float = np.nan):
    """Chaos hook: once ticket ``ticket_id`` reaches member step
    ``at_step``, poison one element of ``field`` in its *live* state — in
    place in its bucket slot's row (that member only), or in a copy of a
    solo ticket's state — with ``value``.  The next pump chunk propagates
    it, and a :class:`~repro_torch.core.health.HealthPolicy` guard should
    quarantine exactly that member."""

    def hook(driver) -> bool:
        t = driver._tickets.get(ticket_id)
        if t is None or t.status in ("done", "failed"):
            return True                       # too late — retire
        if t.step < at_step:
            return False
        if t._bucket is not None and t._slot is not None:
            # the ticket keeps its last stepped state (a copy), as the
            # reference's immutable one is kept; the slot row is poisoned
            t._state = {f: a.clone() for f, a in t._state.items()}
            row = t._bucket.state[field][t._slot]
            row[(0,) * row.ndim] = value
        else:
            a = t._state[field].clone()
            a[(0,) * a.ndim] = value
            t._state = {**t._state, field: a}
        return True

    return hook


def raise_in_pump(at_pump: int = 1):
    """Chaos hook: raise :class:`InjectedFault` from inside
    :meth:`FleetDriver.pump` itself, *outside* the per-bucket fault
    protocol — the pump-thread crash.  One-shot: fires on the first pump
    round where ``driver._pumps + 1 >= at_pump``."""
    armed = {"live": True}

    def hook(driver) -> bool:
        if not armed["live"]:
            return True
        if driver._pumps + 1 >= at_pump:
            armed["live"] = False
            raise InjectedFault(
                f"injected pump-thread fault at pump round "
                f"{driver._pumps + 1}")
        return False

    return hook


def kill_pump_thread(driver) -> None:
    """Abruptly stop a driver's background pump thread: no graceful
    shutdown, no final checkpoint flush — what a SIGKILL mid-service leaves
    behind.  Restore-path tests pair this with :meth:`FleetDriver.restore`."""
    driver._stop.set()
    with driver._lock:
        driver._cond.notify_all()
    if driver._thread is not None:
        driver._thread.join()
        driver._thread = None


# ---------------------------------------------------------------------------
# checkpoint damage
# ---------------------------------------------------------------------------

def corrupt_checkpoint(root: str, *, step: int | None = None,
                       mode: str = "flip") -> str:
    """Deterministically damage the checkpoint at ``step`` (default: the
    newest) under ``root``.  Modes:

    * ``"flip"`` — XOR one byte in the first array shard (sha256 mismatch;
      the file still loads).
    * ``"truncate"`` — cut the first array shard in half (torn write).
    * ``"manifest"`` — truncate ``manifest.json`` (unreadable step).

    Returns the damaged directory path.
    """
    from repro_torch.checkpoint.store import _MANIFEST, _step_dir, latest_step

    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {root}")
    path = _step_dir(root, int(step))
    if mode == "manifest":
        mpath = os.path.join(path, _MANIFEST)
        size = os.path.getsize(mpath)
        with open(mpath, "r+b") as fh:
            fh.truncate(max(1, size // 2))
        return path
    arrs = sorted(f for f in os.listdir(path) if f.endswith(".npy"))
    if not arrs:
        raise FileNotFoundError(f"checkpoint {path} has no array shards")
    fp = os.path.join(path, arrs[0])
    size = os.path.getsize(fp)
    if mode == "flip":
        with open(fp, "r+b") as fh:
            off = min(128, size - 1)           # land inside the payload
            fh.seek(off)
            b = fh.read(1)
            fh.seek(off)
            fh.write(bytes([b[0] ^ 0xFF]))
    elif mode == "truncate":
        with open(fp, "r+b") as fh:
            fh.truncate(max(1, size // 2))
    else:
        raise ValueError(f"unknown corruption mode {mode!r}; expected "
                         f"'flip', 'truncate' or 'manifest'")
    return path
