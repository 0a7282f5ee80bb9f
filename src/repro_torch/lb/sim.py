"""Binary-fluid simulation — the end-to-end Ludwig-style application.

One timestep:
  1. moment pass:   φ = Σ_i g_i                      (site-local)
  2. stencil pass:  ∇φ, ∇²φ                          (nearest-neighbour)
  3. collision:     (f, g, φ, ∇φ, ∇²φ) → (f', g')     ← hot spot
  4. streaming:     f'_q(x+c_q) ← f'_q(x)

The step shapes live in :mod:`repro_torch.lb.programs` as declarative stage
graphs; :class:`~repro_torch.core.program.Program` owns the per-stage
executor routing and the ping-pong stepping.

``fused`` selects the hot-loop fusion strategy (all trajectories agree
state-for-state within float32 rounding):

* ``False`` — the 4-launch unfused pipeline above (one 5-stage Program).
* ``"one_launch"`` (or ``True``) — one stencil stage per step over the
  radius-2 composed g-neighbourhood.
* ``"two_launch"`` — launch A streams g's moments into a 1-component φ
  intermediate, launch B (radius-1 stencils only) streams/collides
  against it.

In every fused mode the iterated state is the pre-stream populations
w = collide(u), since (stream∘collide)ⁿ = stream ∘ (collide∘stream)ⁿ⁻¹ ∘
collide — the prologue (collide) and epilogue (stream) run once as their
own Programs.

Device and executors: with no ``device=`` the simulation runs on ``cuda``
and raises ``RuntimeError`` when no card is present.  On the card the
default backend is ``"cuda"`` (unfused) or ``"cuda_windowed"`` (fused) at
``vvl=1``; on the CPU it is ``"torch"`` at the process default VVL.  A
CUDA backend defaults to ``vvl=1`` on either device (on CPU tensors it runs
the plain versions).  A ``target`` with ``layout="aosoa"`` runs every regime
on AoSoA operands (its ``vvl`` the block width; on ``"cuda_windowed"`` a
divisor of the grid's ``Y·Z``).

dtype: ``torch.float32`` (default) or ``torch.bfloat16`` (anything else
raises ``ValueError``).  In bfloat16 the state, the collision constants and
every launch are bfloat16, each op rounded as the reference's Pallas
bodies round it (ROADMAP A7.1c.3): the SoA kernels of ``"cuda"`` and
``"cuda_windowed"`` on the card, the plain bodies on the CPU; on the card
an AoSoA target or a fleet raises ``NotImplementedError`` in bfloat16.  The fused and
unfused regimes' φ round differently in bfloat16 (ascending-q adds against
one float32 sum), so their trajectories differ by more than float32's.

Decompositions: with a ``mesh`` (:func:`repro_torch.launch.mesh.make_mesh`;
or the target's hint), mesh axis *k* of ``shard_axis`` shards grid dim *k*
(slab, pencil or block) and each rank holds and steps its own block of the
grid (``local_shape``), the ghost planes exchanged over ``torch.distributed``
once a step (:class:`~repro_torch.core.program.CompiledProgram`).  The
initial states are built globally from the seed and cut to the rank's
block, :meth:`BinaryFluidSim.observables` reduces over the mesh, and
:meth:`BinaryFluidSim.gather` assembles the global fields on rank 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import Target, as_target, default_vvl, executor_wants
from repro_torch.kernels.lb_collision import NVEL, WEIGHTS
from repro_torch.kernels.ops import resolve_device
from . import programs as lbp
from .params import LBParams

_FUSED_MODES = (False, "one_launch", "two_launch")


@dataclass
class LBState:
    f: torch.Tensor          # (19, X, Y, Z)
    g: torch.Tensor          # (19, X, Y, Z)
    step: int = 0

    @property
    def grid_shape(self) -> tuple[int, int, int]:
        return tuple(self.f.shape[1:])


def from_reference(f, g, params: dict, *, device=None):
    """The port's ``(LBState, LBParams)`` from the reference's state:
    ``f``/``g`` as numpy ``(19, X, Y, Z)`` arrays and its ``LBParams`` as a
    plain dict (``dataclasses.asdict``).  The bits are kept as they are
    (a bfloat16 array, numpy's ``ml_dtypes`` type, by its 16 bits)."""
    dev = resolve_device(device)
    state = LBState(_tensor_of(f, dev), _tensor_of(g, dev))
    return state, LBParams(**params)


def _tensor_of(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


class BinaryFluidSim:
    """Spinodal-decomposition / droplet simulation of a binary mixture.

    The compiled step graphs are exposed as ``sim.programs`` — a dict of
    :class:`~repro_torch.core.program.CompiledProgram`: ``{"step": ...}``
    for the unfused regime, ``{"collide": ..., "fused": ..., "stream": ...}``
    for the fused ones (prologue / hot-loop body / epilogue).
    """

    def __init__(self, grid_shape=(32, 32, 32), params: LBParams | None = None,
                 *, target: Target | str | None = None,
                 backend: str | None = None, vvl: int | None = None,
                 mesh=None, shard_axis: str | tuple[str, ...] | None = None,
                 overlap: bool | None = None,
                 fused: bool | str = False, device=None,
                 dtype=torch.float32):
        self.grid_shape = tuple(int(s) for s in grid_shape)
        self.params = params or LBParams()
        self.device = resolve_device(device)
        if fused is True:
            fused = "one_launch"
        if fused not in _FUSED_MODES:
            raise ValueError(f"fused must be one of {_FUSED_MODES} (or "
                             f"True ≡ 'one_launch'), got {fused!r}")
        self.fused = fused
        on_card = self.device.type == "cuda"
        if target is None:
            if backend is None:
                backend = (("cuda_windowed" if fused else "cuda") if on_card
                           else "torch")
            if vvl is None:
                vvl = 1 if backend.startswith("cuda") else default_vvl()
            target = Target(backend, vvl=vvl, mesh=mesh,
                            shard_axis=shard_axis if mesh is not None
                            else None)
        else:
            target = as_target(target, vvl=vvl)
            if mesh is None:
                mesh = target.mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(
                f"the mesh is on {mesh.device_type!r} but the simulation "
                f"runs on {self.device}; build the mesh for that device")
        self.mesh = mesh
        self.target = target
        # Program compilation routes pointwise stages away from a
        # stencil-only target, but the *unfused* pipeline is
        # pointwise-dominated (collision) — requesting a stencil-only
        # executor for it would quietly measure another one, so fail fast.
        stencil_only = executor_wants(target.executor) == "halo_extended"
        if stencil_only and not fused:
            raise ValueError(
                f"target executor {target.executor!r} is stencil-only "
                f"(wants='halo_extended'); it only runs the fused stencil "
                f"launches — pass fused='one_launch' or 'two_launch'")
        self.backend = target.executor
        self.vvl = target.vvl
        #: the state's dtype: float32, or bfloat16 (every op rounded as the
        #: reference's Pallas bodies round it)
        self.dtype = dtype

        consts = lbp.collision_consts(dtype=lbp.consts_dtype(dtype),
                                      **self.params.as_kwargs())
        kw = dict(grid_shape=self.grid_shape, mesh=mesh,
                  shard_axis=shard_axis, overlap=overlap)
        if fused:
            self.programs = {
                "collide": lbp.collide_program(consts).compile(target, **kw),
                "fused": lbp.fused_program(fused, consts).compile(target,
                                                                  **kw),
                "stream": lbp.stream_program().compile(target, **kw),
            }
        else:
            self.programs = {
                "step": lbp.unfused_step_program(consts).compile(target,
                                                                 **kw),
            }
        hot = self.programs["fused" if fused else "step"]
        #: the block of the grid this rank holds (the grid without a mesh)
        self.local_shape = hot.local_shape
        self.shard_axes = hot.shard_axes

    # -- initialisation ----------------------------------------------------

    def init_spinodal(self, seed: int = 0, noise: float = 0.05) -> LBState:
        """Symmetric quench: φ = small random noise, fluid at rest (the
        reference's numpy draws, so both packages start from the same
        bits)."""
        rng = np.random.default_rng(seed)
        phi0 = noise * (2.0 * rng.random(self.grid_shape) - 1.0)
        return self._equilibrium_state(phi0)

    def init_droplet(self, radius: float | None = None) -> LBState:
        """A φ=+1 droplet in a φ=-1 bath (surface-tension/Laplace tests)."""
        gs = self.grid_shape
        radius = radius or min(gs) / 4.0
        axes = [np.arange(s) - s / 2.0 + 0.5 for s in gs]
        r = np.sqrt(sum(a ** 2 for a in np.meshgrid(*axes, indexing="ij")))
        width = self.params.interface_width
        phi0 = np.tanh((radius - r) / width)
        return self._equilibrium_state(phi0)

    def _equilibrium_state(self, phi0: np.ndarray) -> LBState:
        phi0 = phi0[self._block()]
        w = WEIGHTS.reshape(NVEL, 1, 1, 1)
        # float64 → the state's dtype as numpy (float32) and ml_dtypes
        # (bfloat16: through float32) round it in the reference
        f0 = torch.from_numpy(w * self.params.rho0 * np.ones_like(phi0)[None])
        g0 = torch.from_numpy(w * phi0[None])
        return LBState(f0.to(self.dtype).to(self.device),
                       g0.to(self.dtype).to(self.device))

    def _coords(self, rank: int | None = None) -> tuple[int, ...]:
        """The mesh coordinate of ``rank`` (this rank's by default) along
        each shard axis."""
        if rank is None:
            return tuple(self.mesh.get_local_rank(a) for a in self.shard_axes)
        where = (self.mesh.mesh == rank).nonzero()[0].tolist()
        names = self.mesh.mesh_dim_names
        return tuple(where[names.index(a)] for a in self.shard_axes)

    def _block(self, rank: int | None = None) -> tuple[slice, ...]:
        """The global grid's slices that ``rank`` holds (all of it without a
        mesh)."""
        if self.mesh is None:
            return (slice(None),) * len(self.grid_shape)
        coords = self._coords(rank)
        return tuple(slice(c * n, (c + 1) * n) for c, n in
                     zip(coords, self.local_shape)) + (slice(None),) * (
            len(self.grid_shape) - len(coords))

    def gather(self, state: LBState) -> LBState | None:
        """The global state on rank 0 (``None`` on the other ranks): every
        rank's block of ``f`` and ``g`` gathered over the mesh's process
        group and placed at its coordinates.  Without a mesh, ``state``."""
        if self.mesh is None:
            return state
        rank, world = dist.get_rank(), dist.get_world_size()
        out = []
        for x in (state.f, state.g):
            x = x.contiguous()
            parts = ([torch.empty_like(x) for _ in range(world)]
                     if rank == 0 else None)
            dist.gather(x, parts, dst=0)
            if rank == 0:
                full = x.new_empty((x.shape[0], *self.grid_shape))
                for r, part in enumerate(parts):
                    full[(slice(None),) + self._block(r)] = part
                out.append(full)
        return LBState(*out, state.step) if rank == 0 else None

    # -- stepping ------------------------------------------------------------

    def step(self, state: LBState, nsteps: int = 1) -> LBState:
        """``nsteps`` steps, one Program step per iteration (fresh output
        tensors each step; the same arithmetic as :meth:`run`)."""
        if nsteps <= 0:
            return state
        s = {"f": state.f, "g": state.g}
        if self.fused:
            s = self.programs["collide"].step(s)
            for _ in range(nsteps - 1):
                s = self.programs["fused"].step(s)
            s = self.programs["stream"].step(s)
        else:
            for _ in range(nsteps):
                s = self.programs["step"].step(s)
        return LBState(s["f"], s["g"], state.step + nsteps)

    def run(self, state: LBState, nsteps: int) -> LBState:
        """``nsteps`` steps with the hot loop on two preallocated ping-pong
        state buffers (:meth:`CompiledProgram.run`); the input state is
        not written."""
        if nsteps <= 0:
            return state
        s = {"f": state.f, "g": state.g}
        if self.fused:
            s = self.programs["collide"].step(s)
            s = self.programs["fused"].run(s, nsteps - 1)
            s = self.programs["stream"].step(s)
        else:
            s = self.programs["step"].run(s, nsteps)
        return LBState(s["f"], s["g"], state.step + nsteps)

    # -- observables ---------------------------------------------------------

    def observables(self, state: LBState) -> dict:
        """Mass, φ statistics and a NaN flag, summed in float64 (at 128³ a
        float32 sum drifts by more than the conservation being checked).
        Under a mesh every rank gets the global values: sums, minima and
        maxima reduced over the mesh, the variance taken about the global
        mean."""
        f, g = state.f.double(), state.g.double()
        phi = g.sum(0)
        rho = f.sum(0)
        if self.mesh is not None:
            return self._mesh_observables(f, g, phi, rho)
        return {
            "mass": float(rho.sum()),
            "phi_total": float(phi.sum()),
            "phi_min": float(phi.min()),
            "phi_max": float(phi.max()),
            "phi_var": float(phi.var(unbiased=False)),
            "rho_min": float(rho.min()),
            "nan": bool(torch.isnan(f).any() | torch.isnan(g).any()),
        }

    def _mesh_observables(self, f, g, phi, rho) -> dict:
        def reduce(values, op):
            t = torch.tensor(values, dtype=torch.float64, device=phi.device)
            dist.all_reduce(t, op=op)
            return t.tolist()

        nan = bool(torch.isnan(f).any() | torch.isnan(g).any())
        mass, phi_total, nans = reduce(
            [float(rho.sum()), float(phi.sum()), float(nan)],
            dist.ReduceOp.SUM)
        phi_min, rho_min, neg_phi_max = reduce(
            [float(phi.min()), float(rho.min()), -float(phi.max())],
            dist.ReduceOp.MIN)
        mean = phi_total / math.prod(self.grid_shape)
        (sq,) = reduce([float(((phi - mean) ** 2).sum())], dist.ReduceOp.SUM)
        return {
            "mass": mass,
            "phi_total": phi_total,
            "phi_min": phi_min,
            "phi_max": -neg_phi_max,
            "phi_var": sq / math.prod(self.grid_shape),
            "rho_min": rho_min,
            "nan": nans > 0,
        }
