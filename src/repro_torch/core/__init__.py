"""The targetDP core on PyTorch: descriptors, the memory model, the launch
path, executors, step graphs (with their domain decompositions) and the
tuning layer.

Public surface (paper → here), as the reference's ``repro.core``:

* lattice/fields: :class:`Lattice`, :func:`token_lattice`, :class:`Field`
  (SoA mandated, AoS kept as the Fig. 1 baseline layout), :class:`Stencil`;
* memory model: :func:`target_malloc`, :func:`copy_to_target`,
  :func:`copy_from_target`, the masked variants, :class:`TargetConst`,
  :class:`BatchedConst`, :func:`sync_target`, :func:`target_free`;
* layout: :data:`LAYOUTS`, :func:`soa_to_aosoa`, :func:`aosoa_to_soa`,
  :func:`aosoa_nblocks` (``Target(layout="aosoa")``);
* execution model: :class:`KernelSpec` + :func:`kernel`, :class:`Target`,
  :func:`tdp_launch` (also exported as ``launch``) dispatching through
  :func:`register_executor`'s table, and :func:`reduce`;
* ensembles and resilience: :class:`ProgramState`,
  :class:`FleetProgram` (``CompiledProgram.vmap``), :class:`FleetDriver`,
  :class:`Ticket`, :class:`HealthPolicy`, :class:`HealthError`,
  :class:`Diagnosis`, the :mod:`fleet`, :mod:`health` and :mod:`faults`
  modules (:class:`InjectedFault`), and ``repro_torch.checkpoint``;
* legacy surface: :func:`site_kernel`, :func:`launch_stencil` and the
  ``launch(kernel, lattice, inputs)`` shim, which is
  :func:`repro_torch.core.execute.launch`.  Unlike the reference, whose
  ``repro.core.launch`` is that shim, ``repro_torch.core.launch`` is the
  declarative entry point the port's modules have called since it began.

The ergonomic import is ``from repro_torch import tdp``.
"""
from . import costmodel, faults, fleet, health
from .api import (
    LaunchPlan,
    WindowVmemError,
    field_view,
    gather_neighbors,
    halo_extend,
    launch,
    launch_ensemble,
    launch_plan,
    pad_sites,
)
from .api import launch as tdp_launch
from .autotune import (
    Candidate,
    TuneReport,
    TuneResult,
    autotune,
    default_space,
    plane_block_candidates,
    wall_clock_timer,
)
from .costmodel import (
    CostEstimate,
    MachineProfile,
    machine_profile,
    predict,
    roofline_seconds,
)
from .execute import launch_stencil, reduce, site_kernel
from .faults import InjectedFault
from .fleet import FleetDriver, FleetProgram, Ticket
from .health import Diagnosis, HealthError, HealthPolicy
from .field import Field, field_like
from .lattice import (
    D3Q19_VELOCITIES,
    STENCIL_D3Q19_PULL,
    STENCIL_GRAD_19PT,
    STENCIL_GRAD_6PT,
    Lattice,
    Stencil,
    token_lattice,
)
from .layout import LAYOUTS, aosoa_nblocks, aosoa_to_soa, soa_to_aosoa
from .memory import (
    BatchedConst,
    TargetConst,
    copy_constant_to_target,
    copy_from_target,
    copy_from_target_masked,
    copy_to_target,
    copy_to_target_masked,
    sync_target,
    target_free,
    target_malloc,
    target_malloc_like,
)
from .program import (
    CompiledProgram,
    Program,
    ProgramPlan,
    Stage,
    exchange_ghosts,
    exchange_stats,
    program,
    resolve_stage_target,
    stage,
)
from .registry import (
    compatible_executors,
    executor_tunables,
    executor_vvls,
    executor_wants,
    get_executor,
    get_executor_entry,
    list_executors,
    register_executor,
    registry_version,
    unregister_executor,
)
from .spec import FieldSpec, KernelSpec, field, kernel
from .state import ProgramState, validate_field
from .target import Target, as_target, default_vvl, set_default_vvl

__all__ = [
    "BatchedConst", "Diagnosis", "FleetDriver", "FleetProgram",
    "HealthError", "HealthPolicy", "InjectedFault", "ProgramState", "Ticket",
    "faults", "fleet", "health", "launch_ensemble",
    "Candidate", "CompiledProgram", "CostEstimate", "D3Q19_VELOCITIES",
    "Field", "FieldSpec", "KernelSpec", "LAYOUTS", "LaunchPlan", "Lattice",
    "MachineProfile", "Program", "ProgramPlan", "STENCIL_D3Q19_PULL",
    "STENCIL_GRAD_19PT", "STENCIL_GRAD_6PT", "Stage", "Stencil", "Target",
    "TargetConst", "TuneReport", "TuneResult", "WindowVmemError",
    "aosoa_nblocks", "aosoa_to_soa", "as_target", "autotune",
    "compatible_executors", "copy_constant_to_target", "copy_from_target",
    "copy_from_target_masked", "copy_to_target", "copy_to_target_masked",
    "costmodel", "default_space", "default_vvl", "exchange_ghosts",
    "exchange_stats", "executor_tunables",
    "executor_vvls", "executor_wants", "field", "field_like", "field_view",
    "gather_neighbors", "get_executor", "get_executor_entry", "halo_extend",
    "kernel", "launch", "launch_plan", "launch_stencil", "list_executors",
    "machine_profile", "pad_sites", "plane_block_candidates", "predict",
    "program", "reduce",
    "register_executor", "registry_version", "resolve_stage_target",
    "roofline_seconds",
    "set_default_vvl", "site_kernel", "soa_to_aosoa", "stage", "sync_target",
    "target_free",
    "target_malloc", "target_malloc_like", "tdp_launch", "token_lattice",
    "unregister_executor", "validate_field", "wall_clock_timer",
]
