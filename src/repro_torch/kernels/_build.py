"""Build the CUDA sources under ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled at first use by its own ``nvcc``
process — all started together — into a shared library with a plain C
interface, loaded with :mod:`ctypes`::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The two LB sources (:data:`UNITS`) are compiled as several objects each
(``tdp_windowed`` seven: its bfloat16 SoA kernels one unit a VVL;
``tdp_gathered`` seventeen: its SoA and ensemble kernels one unit a VVL,
the bfloat16 SoA ones two a VVL, the fused site functions apart), one
``nvcc -c -DTDP_UNIT=k`` a unit, and linked with ``nvcc -shared``.

Output goes to ``build/repro_torch/<digest>/`` at the repository root,
keyed by a hash of every source and the flags, so an edited source always
rebuilds.  ``<name>.log`` beside each library keeps ``ptxas``'s register,
shared-memory and spill report.  A missing or failing ``nvcc`` raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("tdp_gathered", "tdp_windowed", "lb_collision", "tdp_gathered_lm",
           "flash_attention", "calibrate", "tdp_gathered_example")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: The flags of one unit's object (``-c``; the link adds ``-shared``).
COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared")
LINK_FLAGS = (*NVCC_FLAGS[:2], "-shared")
#: Sources compiled as several translation units, ``-DTDP_UNIT=k`` for k in
#: 1..n (each groups its entry points by it), in parallel with the other
#: sources, and linked into one library: their SoA, AoSoA and ensemble
#: kernels are most of the build's time.  ``tdp_gathered``'s SoA and
#: ensemble kernels are split further, one unit a VVL, its bfloat16 SoA
#: kernels two a VVL (``fused`` and ``fused_two`` apart from the rest);
#: ``tdp_windowed``'s bfloat16 SoA kernels one unit a VVL.
UNITS = {"tdp_gathered": 17, "tdp_windowed": 7}

#: Site functions in the order of the C enum ``tdp::SiteId``.
SITES = ("stream", "grad6", "moment", "collide", "fused", "phi_stream",
         "fused_two")
SITE_ID = {name: i for i, name in enumerate(SITES)}

#: LM site functions (``csrc/lm_sites.cuh``) in the order of the C enum
#: ``tdp::lm::SiteId``, and their activations in that of ``tdp::lm::ActId``.
#: The ``mamba`` site function has an entry of its own
#: (``tdp_gathered_mamba_launch``) and so no id.
LM_SITES = ("rmsnorm", "gated", "act")
LM_SITE_ID = {name: i for i, name in enumerate(LM_SITES)}
LM_ACTS = ("silu", "gelu_tanh", "relu2")
LM_ACT_ID = {name: i for i, name in enumerate(LM_ACTS)}

#: The paper's example site functions (``csrc/example_sites.cuh``) in the
#: order of the C enum ``tdp::ex::SiteId``.
EXAMPLE_SITES = ("scale", "saxpy", "site_pos")
EXAMPLE_SITE_ID = {name: i for i, name in enumerate(EXAMPLE_SITES)}
#: The reductions of ``tdp_gathered_example_reduce_launch`` in the order of
#: the C enum ``tdp::ex::ReduceOpId``, and the blocks per component group
#: it uses at most (``EX_RED_MAX_BLOCKS``: its scratch is ``ncomp`` times
#: that many doubles).
REDUCE_OPS = ("sum", "max", "min")
REDUCE_OP_ID = {name: i for i, name in enumerate(REDUCE_OPS)}
REDUCE_MAX_BLOCKS = 1024

#: Storage types of the C entries that take a dtype code (the SoA entries of
#: every site-function executor, ``lb_collision_launch``,
#: ``flash_attention_launch``), in the order of the C enum ``tdp::DtypeId``
#: (``csrc/bf16.cuh``), by torch dtype name.
DTYPES = ("float32", "bfloat16")
DTYPE_ID = {name: i for i, name in enumerate(DTYPES)}

#: The d_state values the ``mamba`` site function is instantiated for.
MAMBA_NSTATES = (8, 16)

#: Wall seconds of each ``nvcc`` of the last :func:`build` that compiled,
#: from the start of all of them to the end of each.
BUILD_SECONDS: dict[str, float] = {}

#: ``ERR_*`` return codes of the C entries (cudaError_t values are >= 0).
_ERRORS = {-1: "unknown site function", -2: "VVL not in {1, 2, 4, 8}",
           -3: "head_dim not instantiated (16, 32, 64, 80, 128, 192, 256)",
           -4: "Hq is not a multiple of Hkv",
           -5: f"d_state not instantiated {MAMBA_NSTATES}",
           -6: "a stencil radius exceeds a periodic extent or the ghost "
               "planes",
           -7: "plane_block must be positive and its tile fit the 227 KB a "
               "block may hold",
           -8: f"reduction op not in {REDUCE_OPS}",
           -9: "the ensemble extent must be in 1..65535 (blockIdx.y)",
           -10: f"storage type not in {DTYPES}"}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of repro_torch are built from source at first use")
    return path


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> dict[str, Path]:
    """Compile every source that is not built yet, in parallel; return
    ``{name: library path}``.  A source of :data:`UNITS` is compiled as its
    units, each an object of its own, and linked once they are all done."""
    out = build_dir()
    libs = {name: out / f"lib{name}.so" for name in SOURCES}
    todo = [name for name in SOURCES if not libs[name].exists()]
    if not todo:
        return libs
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []            # (source, unit or step, log path, process), in order
    left, failed, built = {}, [], set()

    def lib_tmp(name):
        return out / f"lib{name}.so.{tag}"

    def objects(name):
        # nvcc takes a file's kind from its suffix: ".o" last
        return [out / f"{name}.{k}.{tag}.o" for k in range(1, UNITS[name] + 1)]

    def start(name, cmd, what):
        log = out / f"{name}.log.{what}.{tag}"
        with open(log, "w") as f:
            jobs.append((name, what, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT)))

    try:
        for name in todo:
            src = str(CSRC / f"{name}.cu")
            if name in UNITS:
                for k, obj in enumerate(objects(name), 1):
                    start(name, [nvcc, *COMPILE_FLAGS, f"-DTDP_UNIT={k}", "-c",
                                 "-o", str(obj), src], f"unit{k}")
                left[name] = UNITS[name]
            else:
                start(name, [nvcc, *NVCC_FLAGS, "-o", str(lib_tmp(name)), src],
                      "nvcc")
                left[name] = 1
        done, linked = set(), set()
        while len(done) < len(jobs):
            for i, (name, what, _, proc) in enumerate(list(jobs)):
                if i in done or proc.poll() is None:
                    continue
                done.add(i)
                if name in UNITS:
                    BUILD_SECONDS[f"{name}.{what}"] = time.perf_counter() - t0
                if proc.returncode and name not in failed:
                    failed.append(name)
                left[name] -= 1
                if left[name] or name in failed:
                    continue
                if name in UNITS and name not in linked:
                    linked.add(name)
                    left[name] = 1
                    start(name, [nvcc, *LINK_FLAGS, "-o", str(lib_tmp(name)),
                                 *map(str, objects(name))], "link")
                else:
                    built.add(name)
                    BUILD_SECONDS[name] = time.perf_counter() - t0
            time.sleep(0.1)
    finally:
        for *_, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for name in todo:
            logs = [log for n, _, log, _ in jobs if n == name]
            (out / f"{name}.log").write_text(
                "".join(log.read_text() for log in logs if log.exists()))
            for log in logs:
                log.unlink(missing_ok=True)
            for obj in objects(name) if name in UNITS else ():
                obj.unlink(missing_ok=True)
            if name in built:
                os.replace(lib_tmp(name), libs[name])
            else:
                lib_tmp(name).unlink(missing_ok=True)
    if failed:
        report = "\n".join(f"--- {n}.cu ---\n{(out / f'{n}.log').read_text()}"
                           for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{report}")
    return libs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu`` (built on first call)."""
    return ctypes.CDLL(str(build()[name]))


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned anything but 0."""
    if rc == 0:
        return
    if rc in _ERRORS:
        raise ValueError(f"{what}: {_ERRORS[rc]}")
    raise RuntimeError(f"{what}: the launch failed with cudaError_t {rc}")


def dtype_id(dtype) -> int:
    """The C entries' code of a torch dtype (:data:`DTYPE_ID`)."""
    return DTYPE_ID[str(dtype).removeprefix("torch.")]


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the int a C entry takes."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
