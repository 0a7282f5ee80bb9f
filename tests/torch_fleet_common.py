"""The demo program of the reference's fleet tests (``tests/test_fleet.py``,
``tests/test_resilience.py``) in both packages: two stages, a sweepable
``tau``, on a 6 × 5 grid.  Imported by the ``test_torch_*`` fleet,
resilience and checkpoint tests; the members are the same seeded numpy
draws for both."""
import jax.numpy as jnp
import numpy as np
import torch

from repro import tdp as jtdp
from repro_torch import tdp

GRID = (6, 5)
W = np.array([0.25, 0.75], np.float32)
TAUS = np.array([0.7, 1.0, 1.3], np.float32)


@tdp.kernel(fields=[tdp.field(2)], out=2)
def _relax(x, tau=1.0, w=None):
    return x - (x - torch.as_tensor(w, dtype=x.dtype)[:, None]) / tau


@tdp.kernel(fields=[tdp.field(2), tdp.field(2)], out=2)
def _mix(x, y, eps=0.1):
    return x + eps * (y - x)


@jtdp.kernel(fields=[jtdp.field(2)], out=2)
def _jrelax(x, tau=1.0, w=None):
    return x - (x - w[:, None]) / tau


@jtdp.kernel(fields=[jtdp.field(2), jtdp.field(2)], out=2)
def _jmix(x, y, eps=0.1):
    return x + eps * (y - x)


def make_prog(tau_const, name="demo"):
    return tdp.Program(name, [
        tdp.stage(_relax, ["a"], ["tmp"],
                  consts={"tau": tau_const, "w": tdp.TargetConst(W)}),
        tdp.stage(_mix, ["a", "tmp"], ["a"], consts={"eps": 0.05}),
    ], fields=["a"])


def jmake_prog(tau_const, name="demo"):
    return jtdp.Program(name, [
        jtdp.stage(_jrelax, ["a"], ["tmp"],
                   consts={"tau": tau_const, "w": jtdp.TargetConst(W)}),
        jtdp.stage(_jmix, ["a", "tmp"], ["a"], consts={"eps": 0.05}),
    ], fields=["a"])


def _draws(n, seed, grid):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2,) + grid).astype(np.float32)
            for _ in range(n)]


def members(n, seed=0, grid=GRID):
    return [{"a": torch.tensor(a)} for a in _draws(n, seed, grid)]


def jmembers(n, seed=0, grid=GRID):
    return [{"a": jnp.asarray(a)} for a in _draws(n, seed, grid)]


PROG = make_prog(tdp.TargetConst(np.float32(1.0)))


def fault_free_reference(ms, nsteps=8):
    """Final states of a fault-free swept fleet run: what every chaos test
    holds the healthy members to, bit for bit."""
    drv = tdp.FleetDriver("torch", batch=len(ms))
    ts = [drv.submit(PROG, {"state": ms[i], "consts": {"tau": TAUS[i]}},
                     nsteps) for i in range(len(ms))]
    final = drv.drain()
    return [final[t.id]["a"] for t in ts]
