"""D3Q19 binary-fluid lattice-Boltzmann collision — the paper's benchmark.

This is the "binary collision" kernel of §IV: a BGK collision of two
distributions (f for the fluid, g for the composition order parameter φ)
with a free-energy force, site-local over 19+19+5 components per site.

* moments:        ρ = Σᵢ fᵢ,   ρu = Σᵢ fᵢcᵢ + F/2,   φ = Σᵢ gᵢ
* free energy:    μ = -A φ + B φ³ - κ ∇²φ
* force:          F = μ ∇φ
* equilibria:     fᵢᵉq = wᵢ ρ (1 + 3cᵢ·u + 9/2 (cᵢ·u)² - 3/2 u²)
                  gᵢᵉq = wᵢ (3Γμ + 3φ cᵢ·u)  (i≥1);  g₀ᵉq = φ - Σ_{i≥1} gᵢᵉq
* collision:      fᵢ' = fᵢ - (fᵢ - fᵢᵉq)/τ + (1 - 1/2τ) wᵢ (3(cᵢ-u) + 9cᵢ(cᵢ·u))·F
                  gᵢ' = gᵢ - (gᵢ - gᵢᵉq)/τ_φ

Two realisations of one function:

* :func:`collision_site_kernel` — the plain site kernel (torch ops over the
  trailing site axis), run by the ``"torch"`` executor and, on CPU tensors,
  by every wrapper;
* :func:`lb_collision` — the wrapper of the hand-written CUDA kernel
  ``csrc/lb_collision.cu`` (the port of ``lb_collision_pallas``), which runs
  the same arithmetic as ``collide_core`` in ``csrc/lb_sites.cuh``.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core.target import CUDA_VVLS

from . import _build, bf16

# index 0: rest; 1..6: axis vectors; 7..18: face diagonals.
CV = np.array(
    [[0, 0, 0],
     [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1],
     [1, 1, 0], [1, -1, 0], [-1, 1, 0], [-1, -1, 0],
     [1, 0, 1], [1, 0, -1], [-1, 0, 1], [-1, 0, -1],
     [0, 1, 1], [0, 1, -1], [0, -1, 1], [0, -1, -1]],
    dtype=np.float64,
)
WEIGHTS = np.array([1.0 / 3.0] + [1.0 / 18.0] * 6 + [1.0 / 36.0] * 12,
                   dtype=np.float64)
NVEL = 19
NDIM = 3

#: the physics scalars and their defaults (a symmetric quench)
PHYS_DEFAULTS = dict(A=0.0625, B=0.0625, kappa=0.04, tau=1.0, tau_phi=1.0,
                     gamma=1.0)

#: kernel launches of the CUDA wrapper, by site function
launches = {"collide": 0}


def collision_site_kernel(f, g, phi, gradphi, del2phi, *,
                          w=None, c=None, A=0.0625, B=0.0625, kappa=0.04,
                          tau=1.0, tau_phi=1.0, gamma=1.0):
    """Binary collision over the trailing site axis (plain version).

    Args:
      f: (19, n) fluid distribution.
      g: (19, n) order-parameter distribution.
      phi: (1, n) order parameter (Σg, precomputed by the moment pass).
      gradphi: (3, n) ∇φ (stencil pass).
      del2phi: (1, n) ∇²φ (stencil pass).
      w, c: TARGET_CONST weight vector (19,) and velocity set (19, 3).
      A, B, kappa, tau, tau_phi, gamma: scalar TARGET_CONSTs.

    Returns ``(f', g')``, both (19, n), in f's dtype.  In bfloat16 every op
    rounds as the reference's body does op by op (:mod:`.bf16`): the
    scalars rounded first, the sums and the two contractions with ``c`` in
    float32, rounded once.
    """
    dt, dev = f.dtype, f.device
    s = functools.partial(bf16.weak, dtype=dt)
    bf = dt == torch.bfloat16
    # the velocity set as the bfloat16 contractions take it: on the host,
    # rounded as the body's c is
    c_host = bf16.round_f64(torch.as_tensor(c).double().cpu().numpy()) if bf \
        else None
    w = torch.as_tensor(w, dtype=dt, device=dev)[:, None]      # (19, 1)
    c = torch.as_tensor(c, dtype=dt, device=dev)               # (19, 3)
    phi_ = phi[0]
    d2 = del2phi[0]

    def cdot(x):                                               # (19, n)
        if bf:
            return bf16.contract(c_host, x)
        return torch.einsum("qd,dv->qv", c, x)

    mu = s(-A) * phi_ + s(B) * phi_ * phi_ * phi_ - s(kappa) * d2
    force = mu[None, :] * gradphi                              # (3, n)

    rho = bf16.sum0(f)
    mom = (bf16.contract(c_host.T, f) if bf
           else torch.einsum("qd,qv->dv", c, f))
    u = (mom + 0.5 * force) / rho[None, :]

    cu = cdot(u)
    usq = bf16.sum0(u * u)
    feq = w * rho[None, :] * (1.0 + 3.0 * cu + 4.5 * cu * cu
                              - 1.5 * usq[None, :])

    cf = cdot(force)
    uf = bf16.sum0(u * force)
    fterm = s(1.0 - 0.5 / tau) * w * (3.0 * (cf - uf[None, :])
                                      + 9.0 * cu * cf)
    f_out = f - (f - feq) / s(tau) + fterm

    gt = w * (s(3.0 * gamma) * mu[None, :] + 3.0 * phi_[None, :] * cu)
    g0 = phi_ - (bf16.sum0(gt) - gt[0])                        # rest population
    geq = torch.cat([g0[None, :], gt[1:]], dim=0)
    g_out = g - (g - geq) / s(tau_phi)
    return f_out, g_out


collision_site_kernel.__cuda_site__ = "collide"


def check_d3q19_consts(consts: dict, what: str, dtype=torch.float32) -> None:
    """The CUDA kernels compile D3Q19's weights and velocities in; refuse
    ``w``/``c`` consts that differ from them as a launch in ``dtype`` takes
    them (in bfloat16 rounded to bfloat16, as ``collision_consts`` gives
    them)."""
    for name, table in (("w", WEIGHTS), ("c", CV)):
        if name not in consts:
            continue
        want = (bf16.round_f64(table) if dtype == torch.bfloat16
                else table.astype(np.float32))
        got = np.asarray(consts[name], dtype=np.float32)
        if got.shape != table.shape or not np.array_equal(got, want):
            raise ValueError(
                f"{what}: const {name!r} differs from the D3Q19 table the "
                f"CUDA kernel is compiled with (in {dtype})")


def cuda_vvl(vvl: int | None) -> int:
    """The sites per thread of a SoA CUDA launch: ``None`` → 1."""
    vvl = CUDA_VVLS[0] if vvl is None else int(vvl)
    if vvl not in CUDA_VVLS:
        raise ValueError(
            f"the CUDA kernels take vvl in {CUDA_VVLS} under layout='soa', "
            f"where it is the sites a thread covers; got {vvl}.  Under "
            f"layout='aosoa' vvl is the width of the AoSoA site block, any "
            f"value >= 1 (on 'cuda_windowed' a divisor of the x-plane's "
            f"sites)")
    return vvl


def check_cuda_tensors(tensors, shapes, what: str,
                       dtypes=(torch.float32,)) -> None:
    """Device, dtype, shape and contiguity checks before a C entry gets the
    pointers: every operand contiguous, on operand 0's device and of its
    dtype, one of ``dtypes``."""
    dev, dt = tensors[0].device, tensors[0].dtype
    names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
    for i, (x, shape) in enumerate(zip(tensors, shapes)):
        if (x.device != dev or x.dtype not in dtypes or x.dtype != dt
                or not x.is_contiguous()):
            raise ValueError(
                f"{what}: operand {i} must be a contiguous {names} tensor on "
                f"{dev} of operand 0's dtype {dt}; got {x.dtype} on "
                f"{x.device}, contiguous={x.is_contiguous()}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{what}: operand {i} has shape "
                             f"{tuple(x.shape)}, expected {tuple(shape)}")


#: the storage types of the LB and example kernels' SoA launches
DTYPES = (torch.float32, torch.bfloat16)


def refuse_bf16(tensors, what: str, item: str) -> None:
    """``NotImplementedError`` for a bfloat16 operand of a launch that takes
    float32 only (the AoSoA launches of the LB and example site functions,
    ROADMAP A7.1c.4; every ensemble launch, A5), naming the queue item
    ``item``.  Nothing is upcast behind the caller's back."""
    if any(isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
           for t in tensors):
        raise NotImplementedError(
            f"{what}: bfloat16 operands are not ported for this launch yet "
            f"(ROADMAP {item}); it takes float32")


def phys_row(consts, dtype) -> np.ndarray:
    """The ``tdp::Phys`` a single LB launch reads (``csrc/lb_sites.cuh``):
    ``(A, B, kappa, tau, tau_phi, gamma, 1 - 1/(2 tau), 3 gamma)`` as 8
    float32.  In float32 as the C ``make_phys`` builds it from the six
    float32 scalars; in bfloat16 each of the eight rounded to bfloat16 from
    its double, the values the plain body's weak scalars take."""
    A, B, kappa, tau, tau_phi, gamma = (float(consts.get(k, v))
                                        for k, v in PHYS_DEFAULTS.items())
    if dtype == torch.bfloat16:
        return bf16.round_f64([A, B, kappa, tau, tau_phi, gamma,
                               1.0 - 0.5 / tau, 3.0 * gamma])
    six = np.array([A, B, kappa, tau, tau_phi, gamma], np.float32)
    return np.array([*six, 1.0 - 0.5 / float(six[3]), 3.0 * float(six[5])],
                    np.float32)


def _lib():
    lib = _build.load("lb_collision")
    fn = lib.lb_collision_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
    return fn


def lb_collision(f, g, phi, gradphi, del2phi, *, vvl: int | None = None,
                 **phys):
    """Binary collision over SoA tensors ``(ncomp, nsites)``.

    CUDA tensors launch ``csrc/lb_collision.cu`` (``vvl`` sites per thread,
    ``None`` → 1) or raise; CPU tensors run :func:`collision_site_kernel`.
    float32 or bfloat16, one dtype for every operand and the outputs.
    """
    unknown = sorted(set(phys) - set(PHYS_DEFAULTS))
    if unknown:
        raise TypeError(f"lb_collision got unknown physics parameter(s) "
                        f"{unknown}; accepted: {sorted(PHYS_DEFAULTS)}")
    p = {**PHYS_DEFAULTS, **phys}
    vvl = cuda_vvl(vvl)
    if f.device.type == "cpu":
        return collision_site_kernel(f, g, phi, gradphi, del2phi,
                                     w=WEIGHTS, c=CV, **p)
    if f.device.type != "cuda":
        raise ValueError(f"lb_collision runs on CUDA or CPU tensors, got "
                         f"{f.device}")
    n = int(f.shape[-1])
    ins = (f, g, phi, gradphi, del2phi)
    check_cuda_tensors(ins, [(NVEL, n), (NVEL, n), (1, n), (NDIM, n), (1, n)],
                       "lb_collision", DTYPES)
    fo, go = torch.empty_like(f), torch.empty_like(g)
    fn = _lib()
    row = phys_row(p, f.dtype)
    with torch.cuda.device(f.device):
        rc = fn(*(x.data_ptr() for x in ins), fo.data_ptr(), go.data_ptr(),
                n, vvl, _build.dtype_id(f.dtype), row.ctypes.data,
                _build.stream_handle(f.device))
    _build.check(rc, "lb_collision")
    launches["collide"] += 1
    return fo, go
