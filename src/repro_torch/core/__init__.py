"""The targetDP core on PyTorch: descriptors, the launch path, executors,
step graphs (single device) and the tuning layer."""
from . import costmodel
from .api import (
    LaunchPlan,
    WindowVmemError,
    field_view,
    gather_neighbors,
    halo_extend,
    launch,
    launch_plan,
    pad_sites,
)
from .autotune import Candidate, TuneReport, autotune, default_space
from .costmodel import CostEstimate, MachineProfile, machine_profile, predict
from .lattice import (
    D3Q19_VELOCITIES,
    STENCIL_D3Q19_PULL,
    STENCIL_GRAD_19PT,
    STENCIL_GRAD_6PT,
    Lattice,
    Stencil,
)
from .memory import TargetConst
from .program import (
    CompiledProgram,
    Program,
    ProgramPlan,
    Stage,
    program,
    resolve_stage_target,
    stage,
)
from .registry import (
    compatible_executors,
    executor_tunables,
    executor_vvls,
    executor_wants,
    register_executor,
    registry_version,
    unregister_executor,
)
from .spec import FieldSpec, KernelSpec, field, kernel
from .state import validate_field
from .target import Target, as_target, default_vvl

__all__ = [
    "Candidate", "CompiledProgram", "CostEstimate", "D3Q19_VELOCITIES",
    "FieldSpec", "KernelSpec", "LaunchPlan", "Lattice", "MachineProfile",
    "Program", "ProgramPlan", "STENCIL_D3Q19_PULL", "STENCIL_GRAD_19PT",
    "STENCIL_GRAD_6PT", "Stage", "Stencil", "Target", "TargetConst",
    "TuneReport", "WindowVmemError", "as_target", "autotune",
    "compatible_executors", "costmodel", "default_space", "default_vvl",
    "executor_tunables", "executor_vvls", "executor_wants", "field",
    "field_view", "gather_neighbors",
    "halo_extend", "kernel", "launch", "launch_plan", "machine_profile",
    "pad_sites", "predict", "program", "register_executor",
    "registry_version", "resolve_stage_target", "stage",
    "unregister_executor", "validate_field",
]
