"""The paper-facing targetDP API surface on PyTorch: ``from repro_torch import tdp``.

One kernel body, one launch syntax, retargeted by swapping the
:class:`Target` descriptor — the paper's single-source contract as a module
namespace::

    from repro_torch import tdp
    from repro_torch.kernels.example_sites import SCALE_SPEC

    x = tdp.copy_to_target(host_field, dtype="float32")      # on the card
    y = tdp.launch(SCALE_SPEC, tdp.Target("cuda", vvl=2), x,
                   a=tdp.copy_constant_to_target(2.0))

Paper macro → API mapping:

====================  ====================================================
paper                 here
====================  ====================================================
``TARGET_ENTRY``      ``@tdp.kernel`` (or :func:`site_kernel`, the legacy
                      form): a plain PyTorch site body over the trailing
                      site axis; a body with a hand-written CUDA twin names
                      it in ``__cuda_site__`` (``csrc/*_sites.cuh``)
``TARGET_LAUNCH``     :func:`tdp.launch` — ``launch(spec, target, *tensors)``
                      (:func:`launch_stencil` and the legacy
                      ``launch(kernel, lattice, inputs)`` shim of
                      :mod:`repro_torch.core.execute` warn and delegate)
``TARGET_TLP``        the CUDA grid: one thread per ``Target.vvl`` sites,
                      blocks over the lattice (``csrc/tdp_gathered*.cu``,
                      ``csrc/tdp_windowed.cu``)
``TARGET_ILP``        ``Target.vvl`` sites a thread, in {1, 2, 4, 8}
                      (:data:`CUDA_VVLS`); ``vvl=None`` is 1 on the card
``VVL`` AoSoA site    ``Target(layout="aosoa")``: the executors' operands
ordering              in blocks of ``vvl`` sites (:func:`soa_to_aosoa`,
                      :func:`aosoa_to_soa`, :data:`LAYOUTS`,
                      :func:`aosoa_nblocks`), read by AoSoA kernels one
                      site a thread; outputs SoA
``TARGET_CONST``      :class:`TargetConst` / launch ``**consts``
                      (:func:`copy_constant_to_target`)
C-vs-CUDA switch      ``Target("torch")`` (plain PyTorch: the CPU build and
                      the oracle) versus ``Target("cuda")`` (the kernels);
                      :func:`register_executor` adds another
``targetMalloc`` …    :func:`target_malloc`, :func:`target_free`,
``copyToTarget`` …    :func:`copy_to_target`, :func:`copy_from_target` and
                      their ``_masked`` variants, :func:`sync_target`
                      (:mod:`repro_torch.core.memory`)
§V reductions         :func:`reduce`: the site body mapped over the
                      lattice, then summed or max/min over the sites
host step glue        :func:`tdp.program` — multi-launch step graphs with
                      ping-pong fields; ``compiled.vmap(B)`` — fleets of
                      ``B`` members, one ensemble launch a stage
MPI halo exchange     ``program.compile(mesh=...)``: slab, pencil and block
                      decompositions over ``torch.distributed``
                      (:func:`exchange_ghosts`, :func:`exchange_stats`;
                      meshes from :func:`repro_torch.launch.mesh.make_mesh`)
per-device tuning     :func:`tdp.autotune` over executor × VVL ×
                      ``plane_block`` (:func:`plane_block_candidates`, the
                      per-stage ``"stage:<name>"`` keys),
                      :mod:`tdp.costmodel`
====================  ====================================================

Entry points that allocate run on the card unless the caller passes
``device="cpu"``, and raise ``RuntimeError`` without one; a launch runs
where its tensors lie (the ``"cuda"`` executors run their plain versions on
CPU tensors).

Ensembles and resilience (``tdp.fleet``): :class:`ProgramState`,
:class:`BatchedConst`, :class:`FleetProgram` (``CompiledProgram.vmap``: one
ensemble launch a stage), :class:`FleetDriver`, :class:`Ticket`,
:class:`HealthPolicy`, :class:`HealthError`, :class:`Diagnosis`, the
``health`` and ``faults`` modules and :class:`InjectedFault`; checkpoints
through ``repro_torch.checkpoint``.  The reference's ``xla_executor`` is
:func:`torch_executor` here.
"""
from repro_torch.core import costmodel  # noqa: F401  (module: tdp.costmodel)
from repro_torch.core import faults, fleet, health  # noqa: F401  (modules)
from repro_torch.core.api import (  # noqa: F401
    LaunchPlan,
    WindowVmemError,
    field_view,
    gather_neighbors,
    halo_extend,
    launch,
    launch_plan,
    pad_sites,
    torch_executor,
)
from repro_torch.core.autotune import (  # noqa: F401
    Candidate,
    TuneReport,
    TuneResult,
    autotune,
    default_space,
    plane_block_candidates,
    wall_clock_timer,
)
from repro_torch.core.costmodel import (  # noqa: F401
    CostEstimate,
    MachineProfile,
    machine_profile,
    predict,
    roofline_seconds,
)
from repro_torch.core.execute import launch_stencil, reduce, site_kernel  # noqa: F401
from repro_torch.core.faults import InjectedFault  # noqa: F401
from repro_torch.core.fleet import FleetDriver, FleetProgram, Ticket  # noqa: F401
from repro_torch.core.health import Diagnosis, HealthError, HealthPolicy  # noqa: F401
from repro_torch.core.field import Field, field_like  # noqa: F401
from repro_torch.core.lattice import (  # noqa: F401
    D3Q19_VELOCITIES,
    STENCIL_D3Q19_PULL,
    STENCIL_GRAD_6PT,
    STENCIL_GRAD_19PT,
    Lattice,
    Stencil,
    token_lattice,
)
from repro_torch.core.layout import (  # noqa: F401
    LAYOUTS,
    aosoa_nblocks,
    aosoa_to_soa,
    soa_to_aosoa,
)
from repro_torch.core.memory import (  # noqa: F401
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
from repro_torch.core.program import (  # noqa: F401
    CompiledProgram,
    Program,
    ProgramPlan,
    Stage,
    exchange_ghosts,
    exchange_stats,
    program,
    stage,
)
from repro_torch.core.registry import (  # noqa: F401
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
from repro_torch.core.spec import FieldSpec, KernelSpec, field, kernel  # noqa: F401
from repro_torch.core.state import ProgramState, validate_field  # noqa: F401
from repro_torch.core.target import (  # noqa: F401
    CUDA_VVLS,
    Target,
    as_target,
    default_vvl,
    set_default_vvl,
)

__all__ = [
    "Target", "as_target", "default_vvl", "set_default_vvl", "CUDA_VVLS",
    "FieldSpec", "KernelSpec", "field", "kernel",
    "register_executor", "unregister_executor", "get_executor",
    "get_executor_entry", "executor_wants", "executor_tunables",
    "executor_vvls", "list_executors", "registry_version",
    "compatible_executors",
    "launch", "launch_plan", "LaunchPlan", "torch_executor",
    "gather_neighbors", "halo_extend", "field_view", "pad_sites",
    "WindowVmemError",
    "Program", "CompiledProgram", "ProgramPlan", "Stage", "program", "stage",
    "exchange_ghosts", "exchange_stats",
    "autotune", "default_space", "plane_block_candidates", "Candidate",
    "TuneReport", "TuneResult", "wall_clock_timer",
    "costmodel", "CostEstimate", "MachineProfile", "machine_profile",
    "predict", "roofline_seconds",
    "reduce", "site_kernel", "launch_stencil",
    "Lattice", "token_lattice", "Stencil", "D3Q19_VELOCITIES",
    "STENCIL_D3Q19_PULL", "STENCIL_GRAD_6PT", "STENCIL_GRAD_19PT",
    "Field", "field_like",
    "TargetConst", "copy_constant_to_target", "copy_to_target",
    "copy_from_target", "copy_to_target_masked", "copy_from_target_masked",
    "sync_target", "target_free", "target_malloc", "target_malloc_like",
    "validate_field",
    "ProgramState", "BatchedConst", "FleetProgram", "FleetDriver", "Ticket",
    "HealthPolicy", "HealthError", "Diagnosis", "InjectedFault",
    "fleet", "health", "faults",
    "LAYOUTS", "aosoa_nblocks", "aosoa_to_soa", "soa_to_aosoa",
]
