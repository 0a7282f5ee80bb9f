"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; builds the kernels under
``src/repro_torch/csrc`` at first use.  Phases:

1. device — the card's name and power limit (``nvidia-smi``); TF32 off for
   the plain versions;
2. build — every ``csrc/*.cu`` by its own ``nvcc``, in parallel; the
   register and spill report of ``ptxas``;
3. kernels against plain versions — every kernel × site function at 64³
   (plus a ragged 64³ + 37-site pointwise case), VVL 1, 2, 4 and 8, on
   the same inputs as the plain PyTorch version, at the tests' tolerances;
4. main path at 128³ — ``BinaryFluidSim`` 20 steps in the unfused,
   ``one_launch`` and ``two_launch`` regimes from one spinodal state, then
   ``ops.lb_collision`` and ``ops.lb_fused_step`` (windowed and gathered)
   on its result, each path with every launch counter set to 0 just before
   it and read just after; checks NaN-free states, float64 mass
   conservation, pairwise agreement of the regimes, a launch of every
   kernel × site function, and a 16³ trajectory against the plain path on
   the CPU;
5. times at 128³ — each kernel × site function, held once more to its
   plain version at this size, then timed (median of 20 launches, CUDA
   events) beside its plain version, its bound and, where one PyTorch
   call computes the same function (``library_call``), that call, itself
   held to the plain version first; MLUPS per regime.

Prints the kernels line and, last, ``{"ok": true, "device": {...}}``; exits
non-zero, printing no result, when anything fails or no card is present.
Long output goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

#: H100 SXM data-sheet peaks (dense): HBM3 bandwidth and float32 outside the
#: tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

#: Bytes each site function must move per site (inputs read once, outputs
#: written once, float32) and its float32 operations per site, counted by
#: hand from csrc/lb_sites.cuh.
BYTES_PER_SITE = {"collide": 324, "fused": 304, "fused_two": 308,
                  "stream": 152, "moment": 80, "phi_stream": 80, "grad6": 20}
FLOPS_PER_SITE = {"collide": 593, "fused": 732, "fused_two": 606,
                  "stream": 0, "moment": 18, "phi_stream": 18, "grad6": 13}

KERNELS = {
    "tdp_gathered": dict(source="src/repro_torch/csrc/tdp_gathered.cu",
                         replaces="src/repro/kernels/tdp_pointwise.py:76"),
    "tdp_windowed": dict(source="src/repro_torch/csrc/tdp_windowed.cu",
                         replaces="src/repro/kernels/tdp_windowed.py:77"),
    "lb_collision": dict(source="src/repro_torch/csrc/lb_collision.cu",
                         replaces="src/repro/kernels/lb_collision.py:136"),
}
STENCIL_SITES = ("stream", "grad6", "fused", "phi_stream", "fused_two")
PARAMS = dict(A=0.125, B=0.125, kappa=0.02)
PHYS = dict(A=0.125, B=0.11, kappa=0.02, tau=0.9, tau_phi=1.1, gamma=0.8)
GRID = (128, 128, 128)
STEPS = 20
#: Clock cycles the spin kernel of time_ms() holds the stream: about a second
#: at the H100's clocks, longer than the host takes to enqueue 20 launches of
#: the slowest plain version.
HOLD_CYCLES = 2_000_000_000


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def ptxas_report(logs: dict) -> list[dict]:
    """Registers and spills per compiled kernel, from ``-Xptxas -v``."""
    rows = []
    for lib, path in logs.items():
        entry = None
        for line in path.read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                site = re.search(r"tdp(?:\d+)(\w+?)Site", name)
                vvl = re.search(r"Li(\d+)E", name)
                entry = {"lib": lib,
                         "site": site.group(1) if site else "collide",
                         "vvl": int(vvl.group(1)) if vvl else None}
                rows.append(entry)
                continue
            if entry is None:
                continue
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                entry["spill_stores"] = int(m.group(1))
                entry["spill_loads"] = int(m.group(2))
    return rows


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one launch of ``fn`` over ``reps`` launches,
    each between two CUDA events.

    A spin kernel holds the stream while the host enqueues every launch, so
    the events bracket device work only and not the Python dispatch of the
    wrapper (which, on an idle card, would otherwise land between an event
    and its kernel)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(HOLD_CYCLES)
    events[0].record()
    for i in range(reps):
        fn()
        events[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def max_abs(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def compare(site: str, got, want, what: str, problems: list) -> None:
    """Kernel outputs against the plain version's: ``stream`` is a pure copy
    and must be bit-exact, every other site function is held at ``rtol=1e-5,
    atol=1e-6`` (FMA contraction and summation order differ)."""
    ok = all(torch.isfinite(g).all() and (
        torch.equal(g, w) if site == "stream"
        else torch.allclose(g, w, rtol=1e-5, atol=1e-6))
        for g, w in zip(got, want))
    if not ok:
        problems.append(f"{what}: max |kernel - plain| = {max_abs(got, want)}")


def bound(site: str, nsites: int) -> tuple[float, str]:
    t_bytes = BYTES_PER_SITE[site] * nsites / PEAK_BYTES_PER_S * 1e3
    t_ops = FLOPS_PER_SITE[site] * nsites / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(kernel: str, site: str, prepared, n: int):
    """One PyTorch call that computes ``kernel.site`` on the kernel's own
    prepared inputs, as ``(call, split)``: ``call()`` is what is timed and
    ``split`` turns its result into the kernel's ``(ncomp, n)`` outputs for
    the comparison.  ``None`` where no single call computes the function.

    Gathered inputs are the ``(noffsets, ncomp, n)`` stacks, windowed ones
    the halo-extended ``(ncomp, X+2, Y+2, Z+2)`` grids; the windowed
    functions are 3×3×3 correlations with fixed one-hot or difference
    filters (``F.conv3d``), the gathered grad6 a ``(4, 7)`` matrix product.
    """
    import torch.nn.functional as F
    from repro_torch.kernels.lb_collision import CV
    from repro_torch.lb.stencil import _DIRS, _PULL_IDX

    x = prepared[0]
    dev = x.device
    if site == "moment":
        return (lambda: x.sum(0)), (lambda o: (o.reshape(1, n),))
    if kernel == "tdp_gathered" and site in ("stream", "phi_stream"):
        if _PULL_IDX != tuple(range(len(_PULL_IDX))):
            return None             # the diagonal is not the pull slot
        if site == "stream":        # (n, 19): the same values, transposed
            return ((lambda: torch.diagonal_copy(x, 0, 0, 1)),
                    (lambda o: (o.t(),)))
        return (lambda: torch.einsum("qqn->n", x)), (lambda o: (o.reshape(1, n),))
    if site == "grad6":
        # rows ∇φ_x, ∇φ_y, ∇φ_z, ∇²φ over the 6-point star
        w = np.zeros((4, 3, 3, 3), np.float32)
        for d in range(3):
            e = np.eye(3, dtype=int)[d]
            w[(d, *(1 + e))] = 0.5
            w[(d, *(1 - e))] = -0.5
            w[(3, *(1 + e))] = w[(3, *(1 - e))] = 1.0
        w[3, 1, 1, 1] = -6.0
        def split(o):
            o = o.reshape(4, n)
            return o[:3], o[3:]
        if kernel == "tdp_gathered":
            m = torch.from_numpy(np.stack(
                [w[(slice(None), *(1 + np.asarray(o)))] for o in _DIRS], 1)
            ).to(dev)
            p = x.reshape(len(_DIRS), n)
            return (lambda: m @ p), split
        wt = torch.from_numpy(w[:, None]).to(dev)
        return (lambda: F.conv3d(x[None], wt)), split
    if kernel == "tdp_windowed" and site in ("stream", "phi_stream"):
        # population q at site x comes from x - c_q: tap 1 - c_q
        w = np.zeros((19, 3, 3, 3), np.float32)
        for q, c in enumerate(CV.astype(int)):
            w[(q, *(1 - c))] = 1.0
        if site == "stream":
            wt = torch.from_numpy(w[:, None]).to(dev)
            return ((lambda: F.conv3d(x[None], wt, groups=19)),
                    (lambda o: (o.reshape(19, n),)))
        wt = torch.from_numpy(w[None]).to(dev)
        return (lambda: F.conv3d(x[None], wt)), (lambda o: (o.reshape(1, n),))
    return None


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device is available")
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Lattice, Target, gather_neighbors, halo_extend
    from repro_torch.core.api import launch_plan, torch_executor
    from repro_torch.kernels import _build, lb_collision, ops
    from repro_torch.kernels import tdp_pointwise, tdp_windowed
    from repro_torch.lb import programs, stencil
    from repro_torch.lb.params import LBParams
    from repro_torch.lb.sim import BinaryFluidSim

    problems: list[str] = []
    record: dict = {}
    OUT_DIR.mkdir(exist_ok=True)

    # -- 1. device ----------------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record["device"] = {"nvidia_smi": smi, "name": kind,
                        "torch": torch.__version__, "cuda": torch.version.cuda}

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    logs = {name: p.with_name(f"{name}.log") for name, p in libs.items()}
    ptxas = ptxas_report(logs)
    record["build_s"] = build_s
    record["ptxas"] = ptxas
    spills = [r for r in ptxas if r.get("spill_stores") or r.get("spill_loads")]
    print(json.dumps({"build_s": round(build_s, 3), "kernels_compiled":
                      len(ptxas), "spilling": spills}), flush=True)

    counters = {"tdp_gathered": tdp_pointwise.launches,
                "tdp_windowed": tdp_windowed.launches,
                "lb_collision": lb_collision.launches}

    def entries():
        for site in _build.SITES:
            yield "tdp_gathered", site
        for site in STENCIL_SITES:
            yield "tdp_windowed", site
        yield "lb_collision", "collide"

    def make_inputs(spec, n, *, seed):
        """Random fields about a physical state: f = 1/19 + 0.01·N gives
        ρ = 1 ± 0.044, so no site of a 128³ grid comes near ρ = 0, where
        u = j/ρ blows up and the comparison would hold nothing."""
        r = np.random.default_rng(seed)
        xs = []
        for fs in spec.fields:
            x = r.standard_normal((fs.ncomp, n), dtype=np.float32)
            if fs.name == "f":
                x = 1.0 / 19.0 + 0.01 * x
            else:
                x = 0.05 * x
            xs.append(torch.from_numpy(x).to(dev))
        return xs

    def prepare(kernel, spec, xs, shape):
        """The executor's prologue: halo-extended grids for the windowed
        kernel, gathered neighbour stacks for the gathered one."""
        halo = (0,) * len(shape)
        fn = halo_extend if kernel == "tdp_windowed" else gather_neighbors
        return tuple(x if s is None else fn(x, shape, halo, s)
                     for x, s in zip(xs, spec.stencils))

    def run_pair(kernel, site, shape, vvl, xs):
        """(kernel outputs, plain outputs) on the same prepared inputs."""
        spec = stencil.SPECS[site]
        consts = programs.collision_consts(**PHYS) if spec.consts else {}
        if kernel == "lb_collision":
            got = lb_collision.lb_collision(*xs, vvl=vvl, **PHYS)
            want = lb_collision.collision_site_kernel(
                *xs, w=lb_collision.WEIGHTS, c=lb_collision.CV, **PHYS)
            return got, want
        exe = "cuda_windowed" if kernel == "tdp_windowed" else "cuda"
        plan = launch_plan(spec, Target(exe, vvl=vvl), lattice=Lattice(shape),
                           consts=consts)
        prepared = prepare(kernel, spec, xs, shape)
        if kernel == "tdp_windowed":
            return (tdp_windowed.windowed_execute(plan, prepared),
                    tdp_windowed.windowed_plain(plan, prepared))
        return (tdp_pointwise.cuda_execute(plan, prepared),
                torch_executor(plan, prepared))

    # -- 3. kernels against plain versions ----------------------------------
    shape64 = (64, 64, 64)
    max_err: dict = {}
    for kernel, site in entries():
        spec = stencil.SPECS[site]
        cases = [(shape64, 64 ** 3)]
        if not spec.has_stencil:
            cases.append(((64 ** 3 + 37,), 64 ** 3 + 37))
        err = 0.0
        for shape, n in cases:
            xs = make_inputs(spec, n, seed=_build.SITE_ID[site])
            for vvl in (1, 2, 4, 8):
                got, want = run_pair(kernel, site, shape, vvl, xs)
                torch.cuda.synchronize()
                compare(site, got, want, f"{kernel}.{site} vvl={vvl} n={n}",
                        problems)
                err = max(err, max_abs(got, want))
        max_err[(kernel, site)] = err
        log(f"phase 3: {kernel}.{site} max_abs_err={err}")
    torch.cuda.empty_cache()

    # -- 4. main path at 128^3 -----------------------------------------------
    params = LBParams(**PARAMS)
    sims = {r: BinaryFluidSim(GRID, params, fused=r)
            for r in (False, "one_launch", "two_launch")}
    st0 = sims[False].init_spinodal(seed=0, noise=0.05)
    obs0 = sims[False].observables(st0)
    by_path: dict = {}

    def drive(path, fn):
        """Run one path of the main path with every launch counter set to
        0 just before and read just after."""
        for c in counters.values():
            for k in c:
                c[k] = 0
        out = fn()
        torch.cuda.synchronize()
        by_path[path] = {(k, s): counters[k][s] for k, s in entries()
                         if counters[k][s]}
        return out

    finals = {regime: drive(f"BinaryFluidSim fused={regime}",
                            lambda sim=sim: sim.run(st0, STEPS))
              for regime, sim in sims.items()}
    final = finals["two_launch"]
    f2, g2 = final.f.reshape(19, -1), final.g.reshape(19, -1)
    phi = g2.sum(0, keepdim=True)
    grad, lap = stencil.gradients(phi.reshape(GRID))
    fo, go = drive("ops.lb_collision", lambda: ops.lb_collision(
        f2, g2, phi, grad.reshape(3, -1), lap.reshape(1, -1),
        **params.as_kwargs()))
    fused_ops = {}
    for mode in ("one_launch", "two_launch"):
        for tgt in ("cuda_windowed", "cuda"):
            fused_ops[(mode, tgt)] = drive(
                f"ops.lb_fused_step {mode} {tgt}",
                lambda mode=mode, tgt=tgt: ops.lb_fused_step(
                    f2, g2, grid_shape=GRID, mode=mode, target=Target(tgt),
                    **params.as_kwargs()))
    launches = {e: sum(p.get(e, 0) for p in by_path.values())
                for e in entries()}
    launches_by_path = {e: {path: p[e] for path, p in by_path.items() if e in p}
                        for e in entries()}

    for (k, s), n in launches.items():
        if n == 0:
            problems.append(f"{k}.{s} was not launched on the main path")
    for regime, st in finals.items():
        obs = sims[regime].observables(st)
        record.setdefault("observables", {})[str(regime)] = obs
        if obs["nan"]:
            problems.append(f"regime {regime}: NaN in the state")
        if not np.isclose(obs["mass"], obs0["mass"], rtol=1e-5, atol=0):
            problems.append(f"regime {regime}: mass {obs['mass']} vs "
                            f"{obs0['mass']}")
    names = list(finals)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            for fld in ("f", "g"):
                x, y = getattr(finals[a], fld), getattr(finals[b], fld)
                if not torch.allclose(x, y, rtol=2e-4, atol=2e-5):
                    problems.append(
                        f"{fld}: regimes {a} and {b} differ by "
                        f"{float((x - y).abs().max())}")
    for out in (fo, go, *[t for pair in fused_ops.values() for t in pair]):
        if not torch.isfinite(out).all():
            problems.append("non-finite output of an ops entry point")
    for mode in ("one_launch", "two_launch"):
        for i in range(2):
            a, b = fused_ops[(mode, "cuda_windowed")][i], fused_ops[(mode, "cuda")][i]
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-6):
                problems.append(f"lb_fused_step {mode}: windowed and gathered "
                                f"differ by {float((a - b).abs().max())}")
    # small input against the plain path on the CPU (held to the JAX
    # package by the CPU tests)
    small = {}
    for regime in (False, "one_launch", "two_launch"):
        outs = []
        for device in ("cuda", "cpu"):
            sim = BinaryFluidSim((16, 16, 16), params, fused=regime,
                                 device=device)
            st = sim.run(sim.init_spinodal(seed=3, noise=0.05), 10)
            outs.append((st.f.cpu(), st.g.cpu()))
        err = max(float((a - b).abs().max()) for a, b in zip(*outs))
        small[str(regime)] = err
        if not all(torch.allclose(a, b, rtol=2e-4, atol=2e-5)
                   for a, b in zip(*outs)):
            problems.append(f"16^3 regime {regime}: card vs CPU plain path "
                            f"differ by {err}")
    per_path = {path: {f"{k}.{s}": n for (k, s), n in p.items()}
                for path, p in by_path.items()}
    record["main_path"] = {"launches_by_path": per_path,
                           "card_vs_cpu_16cubed_max_abs": small}
    print(json.dumps({"main_path_launches_by_path": per_path}), flush=True)
    del finals, fo, go, fused_ops, grad, lap, phi, final, f2, g2
    torch.cuda.empty_cache()

    # -- 5. times at 128^3 -----------------------------------------------------
    # Each kernel is also held to its plain version once more here, at the
    # main path's size and VVL.
    nsites = int(np.prod(GRID))
    rows = []
    for kernel, site in entries():
        spec = stencil.SPECS[site]
        xs = make_inputs(spec, nsites, seed=100 + _build.SITE_ID[site])
        consts = programs.collision_consts(**PHYS) if spec.consts else {}
        if kernel == "lb_collision":
            def kern():
                return lb_collision.lb_collision(*xs, **PHYS)

            def plain():
                return lb_collision.collision_site_kernel(
                    *xs, w=lb_collision.WEIGHTS, c=lb_collision.CV, **PHYS)
        else:
            exe = "cuda_windowed" if kernel == "tdp_windowed" else "cuda"
            plan = launch_plan(spec, Target(exe, vvl=1), lattice=Lattice(GRID),
                               consts=consts)
            prepared = prepare(kernel, spec, xs, GRID)
            if kernel == "tdp_windowed":
                def kern():
                    return tdp_windowed.windowed_execute(plan, prepared)

                def plain():
                    return tdp_windowed.windowed_plain(plan, prepared)
            else:
                def kern():
                    return tdp_pointwise.cuda_execute(plan, prepared)

                def plain():
                    return torch_executor(plan, prepared)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        compare(site, got, want, f"{kernel}.{site} 128^3", problems)
        err128 = max_abs(got, want)
        max_err[(kernel, site)] = max(max_err[(kernel, site)], err128)
        lib = (None if kernel == "lb_collision"
               else library_call(kernel, site, prepared, nsites))
        library_ms = lib_err = None
        if lib is not None:
            call, split = lib
            lib_out = split(call())
            torch.cuda.synchronize()
            # the library is held to the plain version at the non-copy
            # tolerance whatever the site: it need not round as the port
            compare("library", lib_out, want,
                    f"library call for {kernel}.{site} 128^3", problems)
            lib_err = max_abs(lib_out, want)
            del lib_out
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        if lib is not None:
            library_ms = time_ms(lib[0])
        b_ms, b_by = bound(site, nsites)
        rows.append({"name": f"{kernel}.{site}", "route": "cuda",
                     **KERNELS[kernel], "launches": launches[(kernel, site)],
                     "launches_by_path": launches_by_path[(kernel, site)],
                     "max_abs_err": max_err[(kernel, site)], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library_ms})
        record.setdefault("checks_128cubed", {})[f"{kernel}.{site}"] = {
            "max_abs_err": err128, "library_max_abs_err": lib_err}
        log(f"phase 5: {kernel}.{site} ms={ms:.4f} plain={plain_ms:.4f} "
            f"library={library_ms} bound={b_ms:.4f} err128={err128} "
            f"library_err={lib_err}")
        del xs, lib
        prepared = None
        torch.cuda.empty_cache()

    mlups = {}
    for regime, sim in sims.items():
        sim.run(st0, 2)
        torch.cuda.synchronize()
        t = time.perf_counter()
        sim.run(st0, STEPS)
        torch.cuda.synchronize()
        mlups[str(regime)] = nsites * STEPS / (time.perf_counter() - t) / 1e6
    record["mlups_128cubed_20_steps"] = mlups
    record["kernels"] = rows
    print(json.dumps({"mlups_128cubed_20_steps": mlups}), flush=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                        default=str))

    if problems:
        for p in problems:
            log(f"FAIL: {p}")
        return 1
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
