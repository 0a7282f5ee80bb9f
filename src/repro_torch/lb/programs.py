"""The lattice-Boltzmann step graphs — LB specs assembled into
:class:`repro_torch.core.Program`\\ s.

One module owns every LB step shape;
:class:`repro_torch.lb.sim.BinaryFluidSim` and
:func:`repro_torch.kernels.ops.lb_fused_step` are thin consumers.  The
host-side glue — pointwise-stage executor routing, the halo schedule,
ping-pong stepping — falls out of the Program machinery
(:mod:`repro_torch.core.program`).

The graphs (fields ``f``/``g`` are the persistent, double-buffered
populations):

* :func:`unfused_step_program` — the 4-launch pipeline as 5 stages:
  moments → gradients → collide → stream f → stream g, with ``phi`` /
  ``gradphi`` / ``del2phi`` and the post-collision populations as
  step-local intermediates.
* :func:`fused_program` — the pre-stream iteration body:
  ``one_launch`` (one radius-2 stage) or ``two_launch`` (streamed-φ
  launch A + radius-1 launch B).
* :func:`collide_program` / :func:`stream_program` — the fused regime's
  prologue (u → w = collide(u)) and epilogue (final stream).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import Program, TargetConst, program, stage
from repro_torch.kernels import bf16
from repro_torch.kernels.lb_collision import CV, WEIGHTS

from .stencil import (
    COLLIDE_SPEC,
    FUSED_SPEC,
    FUSED_TWO_SPEC,
    GRAD6_SPEC,
    MOMENT_SPEC,
    PHI_STREAM_SPEC,
    STREAM_SPEC,
)

FIELDS = ("f", "g")


def collision_consts(dtype=np.float32, **phys) -> dict:
    """The collision stages' ``TARGET_CONST`` bindings: weight vector and
    velocity set (content-hashed :class:`TargetConst`\\ s) plus the
    physical scalars (``A``, ``B``, ``kappa``, ``tau``, ``tau_phi``,
    ``gamma``).  ``dtype`` is a numpy dtype or ``torch.bfloat16``, whose
    tables are float32 arrays of the bfloat16-rounded values (numpy has no
    bfloat16; the bodies take them in bfloat16 exactly)."""
    if dtype == torch.bfloat16:
        return dict(w=TargetConst(bf16.round_f64(WEIGHTS)),
                    c=TargetConst(bf16.round_f64(CV)), **phys)
    return dict(w=TargetConst(np.asarray(WEIGHTS, dtype=dtype)),
                c=TargetConst(np.asarray(CV, dtype=dtype)), **phys)


#: the state dtypes the LB programs run in
DTYPES = (torch.float32, torch.bfloat16)


def consts_dtype(dtype):
    """The ``collision_consts`` dtype of a state in ``dtype`` (one of
    :data:`DTYPES`, else ``ValueError``)."""
    if dtype not in DTYPES:
        raise ValueError(f"the LB programs run in {DTYPES}, got {dtype}")
    return np.float32 if dtype == torch.float32 else dtype


def _collide_stages(consts, writes):
    return [
        stage(MOMENT_SPEC, reads="g", writes="phi", name="moments"),
        stage(GRAD6_SPEC, reads="phi", writes=("gradphi", "del2phi"),
              name="gradients"),
        stage(COLLIDE_SPEC, reads=("f", "g", "phi", "gradphi", "del2phi"),
              writes=writes, consts=consts, name="collide"),
    ]


def unfused_step_program(consts) -> Program:
    """One full unfused timestep (moments → ∇φ/∇²φ → collide → stream)."""
    stages = _collide_stages(consts, writes=("fc", "gc")) + [
        stage(STREAM_SPEC, reads="fc", writes="f", name="stream_f"),
        stage(STREAM_SPEC, reads="gc", writes="g", name="stream_g"),
    ]
    return program("lb_step", stages, fields=FIELDS)


def collide_program(consts) -> Program:
    """The fused regime's prologue: u → w = collide(u) (pre-stream)."""
    return program("lb_collide", _collide_stages(consts, writes=FIELDS),
                   fields=FIELDS)


def stream_program() -> Program:
    """The fused regime's epilogue: one streaming pass of both fields."""
    return program("lb_stream", [
        stage(STREAM_SPEC, reads="f", writes="f", name="stream_f"),
        stage(STREAM_SPEC, reads="g", writes="g", name="stream_g"),
    ], fields=FIELDS)


def fused_program(mode, consts) -> Program:
    """The fused hot-loop body w → w' (stream ∘ collide over the
    pre-stream state), in either fusion strategy (the same math):

    * ``"one_launch"`` — one stencil stage over the radius-2 composed
      g-neighbourhood (``FUSED_SPEC``);
    * ``"two_launch"`` — launch A streams g's moments into the
      1-component ``phi_s`` intermediate, launch B (radius-1 stencils)
      streams/collides against it.
    """
    if mode in (True, "one_launch"):
        return program("lb_fused_one", [
            stage(FUSED_SPEC, reads=FIELDS, writes=FIELDS, consts=consts,
                  name="fused"),
        ], fields=FIELDS)
    if mode == "two_launch":
        return program("lb_fused_two", [
            stage(PHI_STREAM_SPEC, reads="g", writes="phi_s",
                  name="phi_stream"),
            stage(FUSED_TWO_SPEC, reads=("f", "g", "phi_s"), writes=FIELDS,
                  consts=consts, name="fused_two"),
        ], fields=FIELDS)
    raise ValueError(f"mode must be 'one_launch' or 'two_launch', "
                     f"got {mode!r}")
