"""The analytical performance model behind tuning.

Port of the reference's ``core/costmodel.py``: the abstraction exposes
enough structure (grid geometry, halo widths, VVL, the per-stage memory
models of :class:`~repro_torch.core.api.LaunchPlan` and
:class:`~repro_torch.core.program.ProgramPlan`) to reason about
performance, and this module turns it into numbers:

* :class:`MachineProfile` — a device's float32 rate, memory rate, shared
  memory per block and link rates.  :func:`calibrate` measures the first
  two with the calibration kernels of
  :mod:`repro_torch.kernels.calibrate` (a streaming add and an FMA chain);
  :func:`machine_profile` caches profiles under
  ``build/repro_torch/tuning/machine-<device>.json``.
* :func:`predict` — a roofline per stage, ``t = max(flops / peak,
  hbm_bytes / bw)``, summed over the step.  FLOPs come from tracing the
  plan's plain PyTorch body on ``meta`` tensors (:func:`kernel_flops`);
  bytes from the plan memory models.  :func:`roofline_seconds` keeps the
  reference's spill and communication terms; :func:`predict` charges the
  communication term (a decomposed step's exchanged bytes over the
  profile's ``link_bw``) and not the spill: no kernel of this package
  stages a window larger than shared memory.

Left out: the reference's second backend, ``source="hlo"``, and its HLO
walker (``analyze``, ``parse_module``, ``collective_bytes``,
``dryrun_record_terms``): they read XLA's compiled HLO text, which PyTorch
does not produce (ROADMAP, queue A, item 8).

:func:`repro_torch.core.autotune.autotune` uses :func:`predict` to rank its
candidates and measure only the top K.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Mapping

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: where profiles (and the autotuner's choices) are cached: ``build/`` at
#: the repository root, which git ignores.
DEFAULT_CACHE_DIR = str(Path(__file__).resolve().parents[3] / "build"
                        / "repro_torch" / "tuning")

#: Shared memory, in bytes, one block may hold on the H100 (227 KB): the cap
#: of :class:`repro_torch.core.api.WindowVmemError` and the default
#: ``vmem_limit`` of :func:`repro_torch.core.autotune.autotune`.
DEFAULT_VMEM_LIMIT = 232_448

__all__ = [
    "MachineProfile", "CostEstimate", "predict", "roofline_seconds",
    "kernel_flops", "calibrate", "machine_profile", "load_profile",
    "store_profile", "profile_path", "DEFAULT_CACHE_DIR",
    "DEFAULT_VMEM_LIMIT",
]


# ---------------------------------------------------------------------------
# machine profiles
# ---------------------------------------------------------------------------

#: table rates per device family.  ``h100``: NVIDIA's H100 SXM data sheet —
#: 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s HBM3, 80 GB,
#: NVLink 450 GB/s each way (``link_bw``: the data sheet's figure, not a
#: calibration — :func:`calibrate` measures no link), one 400 Gb/s NIC per
#: card; 227 KB of shared memory per block.  ``gpu``: the reference's
#: generic row (not the H100's) for any other CUDA card, with 48 KB of
#: static shared memory per block.
#: ``cpu``: the reference's conservative laptop-class row.
_DEFAULT_RATES: dict[str, dict] = {
    "h100": dict(peak_flops=67e12, hbm_bw=3.35e12, link_bw=450e9,
                 dcn_bw=50e9, hbm_bytes=80 * 10 ** 9,
                 vmem_bytes=DEFAULT_VMEM_LIMIT),
    "gpu": dict(peak_flops=60e12, hbm_bw=1500e9, link_bw=25e9,
                dcn_bw=12.5e9, hbm_bytes=40 * 2 ** 30, vmem_bytes=49_152),
    "cpu": dict(peak_flops=1e11, hbm_bw=2e10, link_bw=1e10,
                dcn_bw=1e10, hbm_bytes=8 * 2 ** 30, vmem_bytes=16 * 2 ** 20),
}


def _rates_row(device: str) -> str:
    platform = device.split(":", 1)[0]
    if platform == "cuda":
        return "h100" if "H100" in device else "gpu"
    return "cpu"


@dataclass(frozen=True)
class MachineProfile:
    """Per-device roofline rates.

    ``device`` is ``"<platform>:<device name>"`` (``"cuda:NVIDIA H100 80GB
    HBM3"``, ``"cpu:cpu"``).  ``interpret`` marks a profile the reference
    calibrated through its Pallas interpreter: such a file still loads, but
    :func:`predict` refuses it, as it cannot answer for any plan of this
    package.  ``source`` records provenance: ``"default"`` (table),
    ``"calibrated"`` (measured in this process), ``"cached"`` (read back
    from disk).
    """

    device: str
    interpret: bool = False
    peak_flops: float = 1e11     # FLOP/s
    hbm_bw: float = 2e10         # bytes/s device-memory bandwidth
    vmem_bytes: int = 16 * 2 ** 20         # fast memory per block
    hbm_bytes: int = 8 * 2 ** 30           # device-memory capacity
    link_bw: float = 1e10        # bytes/s card-to-card link, each way
    dcn_bw: float = 1e10         # bytes/s host network
    source: str = "default"

    @classmethod
    def default(cls, device: str | None = None) -> "MachineProfile":
        """The table profile for ``device``, a device kind such as
        ``"cpu:cpu"`` (``None``: the card's, ``RuntimeError`` where none
        is present)."""
        dev = device if device is not None else _device_kind()
        return cls(device=dev, source="default",
                   **_DEFAULT_RATES[_rates_row(dev)])

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "MachineProfile":
        return cls(device=str(d["device"]),
                   interpret=bool(d.get("interpret", False)),
                   peak_flops=float(d["peak_flops"]),
                   hbm_bw=float(d["hbm_bw"]),
                   vmem_bytes=int(d["vmem_bytes"]),
                   hbm_bytes=int(d.get("hbm_bytes", 8 * 2 ** 30)),
                   link_bw=float(d.get("link_bw", 1e10)),
                   dcn_bw=float(d.get("dcn_bw", 1e10)),
                   source=str(d.get("source", "cached")))


def _torch_device(device=None) -> torch.device:
    """The rule of :func:`repro_torch.kernels.ops.resolve_device`: ``None``
    is the card, and a card asked for where none is present raises
    ``RuntimeError``."""
    from repro_torch.kernels.ops import resolve_device   # kernels imports core
    return resolve_device(device)


def _device_kind(device=None) -> str:
    """``"cuda:<name>"`` for a card, ``"<type>:<type>"`` otherwise; ``None``
    is the card (``RuntimeError`` where none is present)."""
    dev = _torch_device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}:{dev.type}"


# -- calibration ----------------------------------------------------------

#: Sizes on the card: two distinct 64 Mi-element operands for the add
#: (768 MiB moved, far past the 50 MB L2) and 16 Mi elements × 1024 FMA
#: rungs (2048 flop per 8 bytes, past the ~20 flop/byte ridge).  On the CPU
#: the plain versions run at sizes a test can afford.
CUDA_SIZES = dict(add_n=1 << 26, fma_n=1 << 24, fma_k=1024)
CPU_SIZES = dict(add_n=1 << 20, fma_n=1 << 14, fma_k=16)

#: Clock cycles a spin kernel holds the stream while the timed launches are
#: enqueued, so that the CUDA events bracket device work only (~25 ms).
_HOLD_CYCLES = 50_000_000


def _cuda_seconds(fn, reps: int) -> float:
    """Fastest of ``reps`` launches of ``fn``, each between CUDA events."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(_HOLD_CYCLES)
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return min(a.elapsed_time(b) for a, b in events) / 1e3


def _host_seconds(fn, reps: int) -> float:
    """Fastest of ``reps`` wall-clock calls of ``fn``."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _measure_rates(dev: torch.device, reps: int) -> dict[str, float]:
    from repro_torch.kernels import calibrate as cal
    sizes = CUDA_SIZES if dev.type == "cuda" else CPU_SIZES
    seconds = _cuda_seconds if dev.type == "cuda" else _host_seconds
    g = torch.Generator(device=dev).manual_seed(0)
    n = sizes["add_n"]
    x = torch.empty(n, device=dev).uniform_(0.25, 0.75, generator=g)
    y = torch.empty(n, device=dev).uniform_(0.25, 0.75, generator=g)
    t_add = seconds(lambda: cal.stream_add(x, y), reps)
    del x, y
    n, k = sizes["fma_n"], sizes["fma_k"]
    v = torch.empty(n, device=dev).uniform_(0.25, 0.75, generator=g)
    t_fma = seconds(lambda: cal.fma_chain(v, k), reps)
    return {"hbm_bw": 12.0 * sizes["add_n"] / t_add,    # 2 reads + 1 write
            "peak_flops": 2.0 * k * n / t_fma}


def calibrate(device=None, *, reps: int = 5) -> MachineProfile:
    """Measure ``device``'s memory and float32 rates into a
    :class:`MachineProfile`.

    On a card it times the calibration kernels (:func:`repro_torch.kernels.
    calibrate.stream_add` over two 64 Mi-element operands: bytes/s;
    :func:`~repro_torch.kernels.calibrate.fma_chain`, 1024 rungs over 16 Mi
    elements: FLOP/s), each the fastest of ``reps`` launches between CUDA
    events.  The reference took its compiled peak from a 512³ XLA matmul;
    the port takes it from the FMA chain, because the port's site kernels
    run on the CUDA cores, not through cuBLAS.  On the CPU it times the
    plain versions by wall clock.  Shared memory and link rates keep their
    table values.

    ``device=None`` is the card; with no card present it raises
    ``RuntimeError`` (pass ``device="cpu"`` for the CPU).  A build or
    launch failure raises."""
    dev = _torch_device(device)
    base = MachineProfile.default(_device_kind(dev))
    return dataclasses.replace(base, source="calibrated",
                               **_measure_rates(dev, max(1, int(reps))))


# -- profile cache (build/repro_torch/tuning/machine-<device>.json) --------

def profile_path(cache_dir: str, device: str, interpret: bool = False) -> str:
    dev = device.replace(" ", "_").replace("/", "_")
    tag = "-interpret" if interpret else ""
    return os.path.join(cache_dir, f"machine-{dev}{tag}.json")


def load_profile(cache_dir: str, device: str,
                 interpret: bool = False) -> MachineProfile | None:
    """The cached profile, or ``None`` on a miss.  A corrupt file, a device
    mismatch or an interpret-flag mismatch is a miss, never an error."""
    path = profile_path(cache_dir, device, interpret)
    try:
        with open(path) as fh:
            d = json.load(fh)
        if (str(d.get("device")) != device
                or bool(d.get("interpret", False)) != bool(interpret)):
            return None
        prof = MachineProfile.from_dict(d)
    except (OSError, ValueError, KeyError, TypeError):
        return None
    return dataclasses.replace(prof, source="cached")


def _atomic_json(cache_dir: str, path: str, prefix: str, obj) -> None:
    """Write ``obj`` to a private tempfile in ``cache_dir`` and
    ``os.replace`` it over ``path``: an interrupted write never truncates
    an entry, and concurrent writers each land a whole file."""
    os.makedirs(cache_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, prefix=prefix, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(obj, fh, indent=1, default=str)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def store_profile(cache_dir: str, profile: MachineProfile) -> str:
    """Persist ``profile`` atomically; returns its path."""
    path = profile_path(cache_dir, profile.device, profile.interpret)
    _atomic_json(cache_dir, path, ".machine-", profile.as_dict())
    return path


_PROFILE_MEMO: dict[tuple, MachineProfile] = {}


def machine_profile(device=None, *, cache_dir: str = DEFAULT_CACHE_DIR,
                    calibrate_if_missing: bool = True,
                    store: bool = False) -> MachineProfile:
    """In-process memo → on-disk cache → :func:`calibrate` → table.

    ``device`` is a torch device (``None``: the card, ``RuntimeError``
    where none is present; ``"cpu"`` times the CPU's plain versions).
    ``store=True`` persists a freshly calibrated profile."""
    kind = _device_kind(device)
    memo_key = (kind, cache_dir)
    prof = _PROFILE_MEMO.get(memo_key) or load_profile(cache_dir, kind)
    if prof is None:
        prof = (calibrate(_torch_device(device)) if calibrate_if_missing
                else MachineProfile.default(kind))
        if store and prof.source == "calibrated":
            store_profile(cache_dir, prof)
    _PROFILE_MEMO[memo_key] = prof
    return prof


# ---------------------------------------------------------------------------
# the estimate
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CostEstimate:
    """One prediction: seconds, the three roofline terms, the inputs they
    came from, and the binding bottleneck (``"compute"``, ``"hbm"``,
    ``"vmem-spill"`` or ``"comm"``).  ``per_stage`` holds one row per
    Program stage."""

    seconds: float
    t_compute: float
    t_hbm: float
    t_comm: float
    flops: float
    hbm_bytes: float
    vmem_bytes: float
    comm_bytes: float
    bottleneck: str
    source: str
    device: str
    per_stage: tuple = ()

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["per_stage"] = [dict(r) for r in self.per_stage]
        return d

    def __repr__(self):
        return (f"CostEstimate({self.seconds:.3g}s, "
                f"bottleneck={self.bottleneck!r}, source={self.source!r}, "
                f"flops={self.flops:.3g}, hbm={self.hbm_bytes:.3g}B, "
                f"comm={self.comm_bytes:.3g}B)")


def roofline_seconds(flops: float, hbm_bytes: float, *,
                     vmem_bytes: float = 0.0, comm_bytes: float = 0.0,
                     profile: MachineProfile,
                     source: str = "analytic") -> CostEstimate:
    """The pure roofline: ``max(flops/peak, hbm/bw · spill) + comm/link``,
    with ``spill = max(1, vmem_bytes / profile.vmem_bytes)``.  Monotone
    non-decreasing in every input."""
    t_c = float(flops) / profile.peak_flops
    spill = (max(1.0, float(vmem_bytes) / profile.vmem_bytes)
             if profile.vmem_bytes else 1.0)
    t_h = (float(hbm_bytes) / profile.hbm_bw) * spill
    t_x = float(comm_bytes) / profile.link_bw
    seconds = max(t_c, t_h) + t_x
    if t_x > max(t_c, t_h):
        bottleneck = "comm"
    elif t_c >= t_h:
        bottleneck = "compute"
    else:
        bottleneck = "vmem-spill" if spill > 1.0 else "hbm"
    return CostEstimate(
        seconds=seconds, t_compute=t_c, t_hbm=t_h, t_comm=t_x,
        flops=float(flops), hbm_bytes=float(hbm_bytes),
        vmem_bytes=float(vmem_bytes), comm_bytes=float(comm_bytes),
        bottleneck=bottleneck, source=source, device=profile.device)


# ---------------------------------------------------------------------------
# FLOP counting: trace the plain body on meta tensors
# ---------------------------------------------------------------------------

#: FLOPs per output element of the reference's elementwise primitives
#: (a copy of its table): transcendentals a conventional 8, data movement
#: free.
_ELEMWISE_FLOPS = {
    "add": 1, "sub": 1, "mul": 1, "div": 2, "neg": 1, "max": 1, "min": 1,
    "abs": 1, "sign": 1, "floor": 1, "ceil": 1, "round": 1, "rem": 2,
    "integer_pow": 1, "square": 1, "clamp": 2, "select_n": 1,
    "eq": 1, "ne": 1, "lt": 1, "le": 1, "gt": 1, "ge": 1,
    "and": 1, "or": 1, "not": 1, "xor": 1,
    "exp": 8, "log": 8, "log1p": 8, "expm1": 8, "tanh": 8, "logistic": 8,
    "sin": 8, "cos": 8, "tan": 8, "atan2": 8, "pow": 8,
    "sqrt": 4, "rsqrt": 4, "cbrt": 8, "erf": 8, "erfc": 8, "erf_inv": 8,
}

#: ATen op → the reference primitive it is charged as.
_ATEN_PRIMITIVE = {
    "add": "add", "sub": "sub", "rsub": "sub", "mul": "mul", "div": "div",
    "neg": "neg", "maximum": "max", "minimum": "min", "abs": "abs",
    "sign": "sign", "floor": "floor", "ceil": "ceil", "round": "round",
    "remainder": "rem", "fmod": "rem", "square": "square",
    "clamp": "clamp", "clamp_min": "max", "clamp_max": "min", "relu": "max",
    "where": "select_n", "eq": "eq", "ne": "ne", "lt": "lt", "le": "le",
    "gt": "gt", "ge": "ge", "logical_and": "and", "logical_or": "or",
    "logical_not": "not", "logical_xor": "xor", "exp": "exp", "log": "log",
    "log1p": "log1p", "expm1": "expm1", "tanh": "tanh",
    "sigmoid": "logistic", "sin": "sin", "cos": "cos", "tan": "tan",
    "atan2": "atan2", "sqrt": "sqrt", "rsqrt": "rsqrt", "erf": "erf",
    "erfc": "erfc", "erfinv": "erf_inv", "reciprocal": "div",
}

#: ATen ops that are one op here and several primitives in the reference,
#: charged as the reference's decomposition: ``gelu`` (tanh form) is
#: integer_pow, mul, add, mul, tanh, add, mul, mul = 15; ``silu`` is
#: logistic + mul = 9.
_ATEN_COMPOSITE = {"gelu": 15, "silu": 9}

#: reductions, charged their input size
_ATEN_REDUCTIONS = {"sum", "mean", "prod", "amax", "amin", "argmax",
                    "argmin", "cumsum", "cumprod", "logsumexp", "var", "std",
                    "any", "all", "linalg_vector_norm", "max", "min"}


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _op_flops(func, args, out) -> float:
    name = func._overloadpacket.__name__.rstrip("_")
    overload = func._overloadname
    outs = out if isinstance(out, (tuple, list)) else (out,)
    n_out = max((_numel(o) for o in outs), default=0)
    if name in ("mm", "bmm", "addmm", "baddbmm"):
        a = args[1] if name in ("addmm", "baddbmm") else args[0]
        return 2.0 * n_out * int(a.shape[-1])
    if name in ("max", "min") and overload == "other":
        return float(n_out)                        # elementwise binary
    if name in _ATEN_REDUCTIONS:
        return float(max((_numel(a) for a in args), default=0))
    if name == "pow":
        e = args[1]
        if (overload == "Tensor_Scalar" and isinstance(e, (int, float))
                and float(e).is_integer()):
            return float(n_out)                    # integer_pow
        return 8.0 * n_out
    if name in _ATEN_COMPOSITE:
        return float(_ATEN_COMPOSITE[name] * n_out)
    prim = _ATEN_PRIMITIVE.get(name)
    return float(_ELEMWISE_FLOPS[prim] * n_out) if prim else 0.0


class _FlopCounter(TorchDispatchMode):
    """Charges every ATen op that reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.total = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += _op_flops(func, args, out)
        return out


def _meta(v):
    if isinstance(v, torch.Tensor):
        return torch.empty(v.shape, dtype=v.dtype, device="meta")
    return v


def kernel_flops(plan) -> float:
    """Arithmetic FLOPs of one launch of ``plan``.

    The plain body is traced once over one VVL chunk on ``meta`` tensors —
    stencil fields as ``(noffsets, ncomp, VVL)``, pointwise fields as
    ``(ncomp, VVL)``, the site indices of a ``site_index`` plan as an
    ``int32`` ``(VVL,)``, tensor consts as meta tensors of their shape — under
    a dispatch mode that charges each ATen op: elementwise ops from the
    reference's table, ``mm``/``bmm``/``addmm`` 2·M·N·K, reductions their
    input size.  The count is scaled by ``nsites / VVL``.
    (``torch.utils.flop_counter`` counts only matrix products and
    convolutions, which would make every LB site function free.)  Returns
    0.0 when the plan has no lattice shape or the body cannot be traced:
    the prediction then falls back to memory-bound, the right prior for
    lattice kernels."""
    if plan.shape is None or plan.field_ncomp is None:
        return 0.0
    vvl = int(plan.vvl)
    stencils = plan.stencils or (None,) * len(plan.field_ncomp)
    args = [torch.empty((int(c or 1), vvl) if s is None
                        else (int(s.noffsets), int(c or 1), vvl),
                        device="meta")
            for c, s in zip(plan.field_ncomp, stencils)]
    if plan.site_index:
        args.append(torch.empty((vvl,), dtype=torch.int32, device="meta"))
    consts = {k: _meta(v) for k, v in (plan.consts or {}).items()}
    try:
        with torch.no_grad(), _FlopCounter() as counter:
            plan.kernel(*args, **consts)
    except Exception:  # noqa: BLE001 — an untraceable body counts as 0
        return 0.0
    nsites = 1
    for s in plan.shape:
        nsites *= int(s)
    return counter.total * (nsites / max(1, vvl))


# ---------------------------------------------------------------------------
# predict
# ---------------------------------------------------------------------------

def _resolve_profile(profile: MachineProfile | None) -> MachineProfile:
    if profile is None:
        return machine_profile()
    if profile.interpret:
        raise ValueError(
            f"MachineProfile(device={profile.device!r}, interpret=True) holds "
            f"the reference's Pallas-interpreter rates and cannot answer for "
            f"a plan of this package; calibrate() the card or the CPU")
    return profile


def _predict_stages(stages, profile, comm=None) -> CostEstimate:
    comm_bytes = float((comm or {}).get("exchanged_bytes_per_step", 0))
    rows = []
    t_c = t_h = flops = hbm = 0.0
    for sname, p in stages:
        est = roofline_seconds(kernel_flops(p), p.hbm_bytes_estimate(),
                               profile=profile)
        rows.append({
            "stage": sname, "executor": p.target.executor,
            "wants": p.wants, "seconds": est.seconds,
            "t_compute": est.t_compute, "t_hbm": est.t_hbm,
            "flops": est.flops, "hbm_bytes": est.hbm_bytes,
            "bottleneck": est.bottleneck})
        t_c += est.t_compute
        t_h += est.t_hbm
        flops += est.flops
        hbm += est.hbm_bytes
    t_x = comm_bytes / profile.link_bw
    if t_x > max(t_c, t_h):
        bottleneck = "comm"
    else:
        bottleneck = "compute" if t_c >= t_h else "hbm"
    return CostEstimate(
        seconds=sum(r["seconds"] for r in rows) + t_x, t_compute=t_c,
        t_hbm=t_h, t_comm=t_x, flops=flops, hbm_bytes=hbm, vmem_bytes=0.0,
        comm_bytes=comm_bytes, bottleneck=bottleneck, source="analytic",
        device=profile.device, per_stage=tuple(rows))


def predict(subject, target=None, profile: MachineProfile | None = None, *,
            grid_shape=None, source: str = "analytic",
            comm=None) -> CostEstimate:
    """Predict the per-step cost of ``subject`` on float32 fields.

    Args:
      subject: a :class:`~repro_torch.core.api.LaunchPlan`,
        :class:`~repro_torch.core.program.ProgramPlan`,
        :class:`~repro_torch.core.program.Program` (planned under
        ``target`` at ``grid_shape``) or
        :class:`~repro_torch.core.program.CompiledProgram` (its own plan
        and :meth:`~repro_torch.core.program.CompiledProgram.comm_stats`).
      target: the target to plan a bare ``Program`` under.
      profile: the :class:`MachineProfile`; ``None`` is
        :func:`machine_profile` of the card (``RuntimeError`` where none is
        present).  A profile with ``interpret=True`` raises ``ValueError``.
      grid_shape: required for a bare ``Program``.
      source: ``"analytic"`` (plan memory models and traced FLOPs).
        ``"hlo"`` raises ``NotImplementedError``: it walks XLA's compiled
        HLO, which PyTorch does not produce (ROADMAP, queue A, item 8).
      comm: the communication stats (any mapping with
        ``exchanged_bytes_per_step``), charged at the profile's
        ``link_bw``; defaults to the subject's ``comm_stats()`` when it
        has one, else no communication term.
    """
    from .api import LaunchPlan
    from .program import CompiledProgram, Program, ProgramPlan

    if source not in ("analytic", "hlo"):
        raise ValueError(f"source must be 'analytic' or 'hlo', got {source!r}")
    if source == "hlo":
        raise NotImplementedError(
            "source='hlo' walks XLA's compiled HLO, which PyTorch does not "
            "produce; it is not ported (ROADMAP, queue A, item 8) — use "
            "source='analytic'")
    if isinstance(subject, CompiledProgram):
        if comm is None:
            comm = subject.comm_stats()
        subject = subject.plan()
    elif isinstance(subject, Program):
        if grid_shape is None:
            raise ValueError("predict over a Program needs grid_shape")
        subject = subject.plan(target, grid_shape=grid_shape)
    if isinstance(subject, ProgramPlan):
        stages = subject.stages
    elif isinstance(subject, LaunchPlan):
        stages = ((subject.name, subject),)
    else:
        raise TypeError(f"predict expects a LaunchPlan, ProgramPlan, Program "
                        f"or CompiledProgram; got {type(subject).__name__}")
    return _predict_stages(stages, _resolve_profile(profile), comm)
