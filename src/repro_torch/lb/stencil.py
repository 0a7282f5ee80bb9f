"""Stencils and streaming for the 3-D lattice, on the targetDP stencil layer.

The neighbourhood math is declared once as
:class:`~repro_torch.core.lattice.Stencil` descriptors attached to
:class:`~repro_torch.core.spec.KernelSpec` field roles and executed by
:func:`repro_torch.core.api.launch`.  Each plain site kernel here (torch ops
over the trailing site axis) has a CUDA twin of the same name in
``csrc/lb_sites.cuh``, named by its ``__cuda_site__`` attribute; the
``"cuda"`` and ``"cuda_windowed"`` executors launch the twin.

Gradients use the 6-point nearest-neighbour star:
  ∇φ_d  = (φ(+e_d) - φ(-e_d)) / 2
  ∇²φ   = Σ_d (φ(+e_d) + φ(-e_d)) - 6 φ

The **fused step** (:data:`FUSED_SPEC`) computes stream → φ moments →
∇φ/∇²φ → binary collision in one launch with no intermediate full-lattice
arrays; its g-field neighbourhood is the Minkowski composition
``grad6 ∘ d3q19-pull`` (radius 2, 57 offsets).  The **two-launch** variant
(:data:`PHI_STREAM_SPEC` + :data:`FUSED_TWO_SPEC`) trades that 57-offset
neighbourhood for a 1-component streamed-φ intermediate while keeping the
same accumulation order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import (
    FieldSpec,
    KernelSpec,
    Lattice,
    STENCIL_D3Q19_PULL,
    STENCIL_GRAD_6PT,
    STENCIL_GRAD_19PT,  # noqa: F401 — re-exported config switch
    Target,
    as_target,
    launch,
)
from repro_torch.kernels import bf16
from repro_torch.kernels.lb_collision import CV, NVEL, collision_site_kernel

_CVI = CV.astype(int)

# slot of the upstream neighbour -c_q in the pull stencil (== q by
# construction; resolved through Stencil.index so the kernels stay correct
# under any offset ordering)
_PULL_IDX = tuple(STENCIL_D3Q19_PULL.index(tuple(-_CVI[q]))
                  for q in range(NVEL))

# gradient star directions, in STENCIL_GRAD_6PT slot order:
# (centre, +x, -x, +y, -y, +z, -z)
_DIRS = STENCIL_GRAD_6PT.offsets

#: g-field neighbourhood of the fused step: populations at d - c_q for every
#: gradient direction d and velocity c_q (radius 2).
STENCIL_FUSED_G = STENCIL_GRAD_6PT.compose(STENCIL_D3Q19_PULL, name="fused_g")

# _FUSED_G_IDX[d][q]: slot of offset (dirs[d] - c_q) in STENCIL_FUSED_G —
# where population q that will stream onto site+dirs[d] sits pre-stream.
_FUSED_G_IDX = tuple(
    tuple(STENCIL_FUSED_G.index(tuple(np.add(d, -_CVI[q])))
          for q in range(NVEL))
    for d in _DIRS)

#: collision TARGET_CONST names shared by the fused specs
_COLLISION_CONSTS = ("w", "c", "A", "B", "kappa", "tau", "tau_phi", "gamma")


# ---------------------------------------------------------------------------
# plain site kernels (torch ops over the trailing site axis)
# ---------------------------------------------------------------------------

def stream_site_kernel(f_nb):
    """Pull streaming: ``f_nb (19, 19, n)`` neighbour stack (slot i =
    populations at site + pull offset i) → streamed ``(19, n)``."""
    return torch.stack([f_nb[_PULL_IDX[q], q] for q in range(NVEL)])


def _grad6_from_p(p):
    """∇φ (3, n) and ∇²φ (n,) from φ at the 7 grad-star slots (p[0] =
    centre, then +x,-x,+y,-y,+z,-z).  One accumulation order, shared by the
    plain, fused and two-launch kernels and by ``grad6_from_p`` in
    ``csrc/lb_sites.cuh``."""
    grad = 0.5 * torch.stack([p[1] - p[2], p[3] - p[4], p[5] - p[6]])
    lap = -6.0 * p[0]
    lap = lap + p[1] + p[2]
    lap = lap + p[3] + p[4]
    lap = lap + p[5] + p[6]
    return grad, lap


def grad6_site_kernel(phi_nb):
    """6-point ∇φ and ∇²φ: ``phi_nb (7, 1, n)`` → ``((3, n), (1, n))``."""
    grad, lap = _grad6_from_p(phi_nb[:, 0])
    return grad, lap[None]


def fused_site_kernel(f_nb, g_nb, *, w=None, c=None, A=0.0625, B=0.0625,
                      kappa=0.04, tau=1.0, tau_phi=1.0, gamma=1.0):
    """Fused stream → moments → gradients → binary collision.

    Args:
      f_nb: (19, 19, n) fluid populations at the pull offsets.
      g_nb: (57, 19, n) order-parameter populations at the composed
        ``STENCIL_FUSED_G`` offsets.
      w, c, A..gamma: the collision TARGET_CONSTs.

    Returns post-collision ``(f', g')``, both (19, n) — the *pre-stream*
    state of the next step.
    """
    f_s = torch.stack([f_nb[_PULL_IDX[q], q] for q in range(NVEL)])
    g_s = torch.stack([g_nb[_FUSED_G_IDX[0][q], q] for q in range(NVEL)])

    # φ of the streamed g at the site and its 6 gradient neighbours —
    # φ(x+d) = Σ_q g(x + d - c_q), ascending q.
    def phi_at(d):
        acc = g_nb[_FUSED_G_IDX[d][0], 0]
        for q in range(1, NVEL):
            acc = acc + g_nb[_FUSED_G_IDX[d][q], q]
        return acc

    p = [phi_at(d) for d in range(len(_DIRS))]         # 7 × (n,)
    grad, lap = _grad6_from_p(p)
    return collision_site_kernel(
        f_s, g_s, p[0][None], grad, lap[None], w=w, c=c, A=A, B=B,
        kappa=kappa, tau=tau, tau_phi=tau_phi, gamma=gamma)


def streamed_phi_site_kernel(g_nb):
    """Launch A of the two-launch fused step: φ of the *streamed* g,
    ``g_nb (19, 19, n)`` pull stack → ``(1, n)``, ascending q (the order
    :func:`fused_site_kernel` uses)."""
    acc = g_nb[_PULL_IDX[0], 0]
    for q in range(1, NVEL):
        acc = acc + g_nb[_PULL_IDX[q], q]
    return acc[None]


def fused_two_site_kernel(f_nb, g_nb, phis_nb, *, w=None, c=None, A=0.0625,
                          B=0.0625, kappa=0.04, tau=1.0, tau_phi=1.0,
                          gamma=1.0):
    """Launch B of the two-launch fused step: stream + collide, reading the
    streamed-φ intermediate through the 7-point gradient star.

    Args:
      f_nb / g_nb: (19, 19, n) populations at the pull offsets.
      phis_nb: (7, 1, n) streamed-φ values at the gradient-star slots.
    """
    f_s = torch.stack([f_nb[_PULL_IDX[q], q] for q in range(NVEL)])
    g_s = torch.stack([g_nb[_PULL_IDX[q], q] for q in range(NVEL)])
    p = [phis_nb[i, 0] for i in range(len(_DIRS))]
    grad, lap = _grad6_from_p(p)
    return collision_site_kernel(
        f_s, g_s, p[0][None], grad, lap[None], w=w, c=c, A=A, B=B,
        kappa=kappa, tau=tau, tau_phi=tau_phi, gamma=gamma)


def phi_moment_site_kernel(g):
    """Order-parameter moment φ = Σ_q g_q, ``g (19, n)`` → ``(1, n)``; in
    bfloat16 summed in float32 and rounded once, as the reference's
    ``jnp.sum`` (where ``phi_at`` and ``streamed_phi_site_kernel`` round at
    every add: the fused and unfused regimes' φ differ in bfloat16)."""
    return bf16.sum0(g, keepdim=True)


for _fn, _site in ((stream_site_kernel, "stream"),
                   (grad6_site_kernel, "grad6"),
                   (fused_site_kernel, "fused"),
                   (streamed_phi_site_kernel, "phi_stream"),
                   (fused_two_site_kernel, "fused_two"),
                   (phi_moment_site_kernel, "moment")):
    _fn.__cuda_site__ = _site


# ---------------------------------------------------------------------------
# kernel specs — the declarative launch surface (what ops/sim dispatch on)
# ---------------------------------------------------------------------------

STREAM_SPEC = KernelSpec(
    stream_site_kernel,
    fields=(FieldSpec(ncomp=NVEL, stencil=STENCIL_D3Q19_PULL, name="f"),),
    out=NVEL)

GRAD6_SPEC = KernelSpec(
    grad6_site_kernel,
    fields=(FieldSpec(ncomp=1, stencil=STENCIL_GRAD_6PT, name="phi"),),
    out=(3, 1))

FUSED_SPEC = KernelSpec(
    fused_site_kernel,
    fields=(FieldSpec(ncomp=NVEL, stencil=STENCIL_D3Q19_PULL, name="f"),
            FieldSpec(ncomp=NVEL, stencil=STENCIL_FUSED_G, name="g")),
    out=(NVEL, NVEL), consts=_COLLISION_CONSTS)

PHI_STREAM_SPEC = KernelSpec(
    streamed_phi_site_kernel,
    fields=(FieldSpec(ncomp=NVEL, stencil=STENCIL_D3Q19_PULL, name="g"),),
    out=1)

FUSED_TWO_SPEC = KernelSpec(
    fused_two_site_kernel,
    fields=(FieldSpec(ncomp=NVEL, stencil=STENCIL_D3Q19_PULL, name="f"),
            FieldSpec(ncomp=NVEL, stencil=STENCIL_D3Q19_PULL, name="g"),
            FieldSpec(ncomp=1, stencil=STENCIL_GRAD_6PT, name="phi_streamed")),
    out=(NVEL, NVEL), consts=_COLLISION_CONSTS)

MOMENT_SPEC = KernelSpec(
    phi_moment_site_kernel,
    fields=(FieldSpec(ncomp=NVEL, name="g"),),
    out=1)

COLLIDE_SPEC = KernelSpec(
    collision_site_kernel,
    fields=(FieldSpec(ncomp=NVEL, name="f"),
            FieldSpec(ncomp=NVEL, name="g"),
            FieldSpec(ncomp=1, name="phi"),
            FieldSpec(ncomp=3, name="gradphi"),
            FieldSpec(ncomp=1, name="del2phi")),
    out=(NVEL, NVEL), consts=_COLLISION_CONSTS)

#: every LB spec, by the name of its CUDA site function
SPECS = {"stream": STREAM_SPEC, "grad6": GRAD6_SPEC, "moment": MOMENT_SPEC,
         "collide": COLLIDE_SPEC, "fused": FUSED_SPEC,
         "phi_stream": PHI_STREAM_SPEC, "fused_two": FUSED_TWO_SPEC}


# ---------------------------------------------------------------------------
# grid-level wrappers (single device: fully periodic)
# ---------------------------------------------------------------------------

def gradients(phi: torch.Tensor, *, target: Target | str | None = None,
              vvl: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """∇φ and ∇²φ of a scalar grid ``(X, Y, Z)`` → ``(3, X, Y, Z)``,
    ``(X, Y, Z)``."""
    gs = tuple(phi.shape)
    lat = Lattice(gs)
    grad, lap = launch(GRAD6_SPEC, as_target(target, vvl=vvl),
                       phi.reshape(1, lat.nsites), lattice=lat)
    return grad.reshape(3, *gs), lap.reshape(gs)


def stream(dist: torch.Tensor, *, target: Target | str | None = None,
           vvl: int | None = None) -> torch.Tensor:
    """Periodic streaming of ``(19, X, Y, Z)``: f_q(x) ← f_q(x - c_q)."""
    gs = tuple(dist.shape[1:])
    lat = Lattice(gs)
    out = launch(STREAM_SPEC, as_target(target, vvl=vvl),
                 dist.reshape(NVEL, lat.nsites), lattice=lat)
    return out.reshape(NVEL, *gs)
