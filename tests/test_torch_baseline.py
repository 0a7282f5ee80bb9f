"""The paper's Fig. 1 baseline (``repro_torch.lb.baseline``): AoS collision
and streaming against the JAX package and against the port's SoA path.

``collide_aos``/``stream_aos`` on AoS ``(X, Y, Z, 19)`` fields at 8³ are
held to ``repro.lb.baseline`` on the same seeded inputs, and, after the
layout transposition, to the SoA site kernels the targetDP path launches
(``COLLIDE_SPEC``/``stream`` under ``"torch"`` and under ``"cuda"`` on CPU
tensors, the plain versions).  Collision at ``rtol=1e-5, atol=1e-6`` (the
same arithmetic in another association order); streaming, a pure copy,
exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.lb import baseline as jbase
from repro.lb import params as jparams
from repro_torch import tdp
from repro_torch.lb import baseline, programs, stencil
from repro_torch.lb.params import LBParams

GRID = (8, 8, 8)
PHYS = dict(A=0.125, B=0.11, kappa=0.02, tau=0.9, tau_phi=1.1, gamma=0.8)
TOL = dict(rtol=1e-5, atol=1e-6)


def _aos_state(seed=5):
    """A physical AoS state: f = 1/19 + 0.01·N, g, φ = Σg, ∇φ, ∇²φ small."""
    rng = np.random.default_rng(seed)
    f = (1 / 19 + 0.01 * rng.normal(size=(*GRID, 19))).astype(np.float32)
    g = (0.05 * rng.normal(size=(*GRID, 19))).astype(np.float32)
    phi = g.sum(-1)
    gp = (0.01 * rng.normal(size=(*GRID, 3))).astype(np.float32)
    d2 = (0.01 * rng.normal(size=GRID)).astype(np.float32)
    return f, g, phi, gp, d2


def _soa(x, ncomp):
    """AoS ``(X, Y, Z, c)`` (or ``(X, Y, Z)``) → SoA ``(c, n)`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(
        x.reshape(-1, ncomp).T))


def test_collide_aos_matches_reference():
    xs = _aos_state()
    want = jbase.collide_aos(*map(jnp.asarray, xs),
                             params=jparams.LBParams(**PHYS))
    got = baseline.collide_aos(*map(torch.from_numpy, xs),
                               params=LBParams(**PHYS))
    for a, b in zip(got, want):
        assert a.shape == (*GRID, 19)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_stream_aos_matches_reference():
    f = _aos_state()[0]
    np.testing.assert_array_equal(
        baseline.stream_aos(torch.from_numpy(f)).numpy(),
        np.asarray(jbase.stream_aos(jnp.asarray(f))))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_collide_aos_matches_the_soa_site_kernel(backend):
    f, g, phi, gp, d2 = _aos_state(7)
    fa, ga = baseline.collide_aos(*map(torch.from_numpy, (f, g, phi, gp, d2)),
                                  params=LBParams(**PHYS))
    fs, gs = tdp.launch(stencil.COLLIDE_SPEC, tdp.Target(backend),
                        _soa(f, 19), _soa(g, 19), _soa(phi, 1), _soa(gp, 3),
                        _soa(d2, 1), **programs.collision_consts(**PHYS))
    for aos, soa in ((fa, fs), (ga, gs)):
        torch.testing.assert_close(aos.reshape(-1, 19).T, soa, **TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_stream_aos_matches_the_soa_stream(backend):
    f = _aos_state(9)[0]
    aos = baseline.stream_aos(torch.from_numpy(f))
    soa = stencil.stream(torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(f, -1, 0))), target=backend)
    assert torch.equal(torch.movedim(aos, -1, 0), soa)


def test_collide_aos_keeps_dtype_and_conserves():
    """float64 stays float64; Σf (mass) and Σg (φ) are conserved per site."""
    xs = [x.astype(np.float64) for x in _aos_state(3)]
    xs[2] = xs[1].sum(-1)
    fo, go = baseline.collide_aos(*map(torch.from_numpy, xs),
                                  params=LBParams(**PHYS))
    assert fo.dtype == torch.float64
    torch.testing.assert_close(fo.sum(-1), torch.from_numpy(xs[0]).sum(-1),
                               rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(go.sum(-1), torch.from_numpy(xs[2]),
                               rtol=1e-12, atol=1e-12)
    assert dataclasses.asdict(LBParams(**PHYS)) == dataclasses.asdict(
        jparams.LBParams(**PHYS))
