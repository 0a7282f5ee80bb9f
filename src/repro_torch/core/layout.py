"""SoA ↔ AoSoA(vvl) layout transforms — the paper's VVL site ordering.

Port of ``repro/core/layout.py``.  targetDP's ``VVL`` macro does more than
strip-mine the ILP loop: in the AoSoA build it *reorders memory* so that each
block of VVL sites stores its components contiguously —
``[site-block][component][site-in-block]`` (arXiv:1405.6162 §III).  This
module is that reordering as a pair of exact inverse transforms applied at
*field boundaries*: callers only ever see SoA ``(ncomp, nsites)`` tensors;
the executors' operands are what change.

Remainder-site contract: when ``vvl`` does not divide ``nsites`` the
trailing partial block is **zero-padded** (:func:`soa_to_aosoa`) and the pad
lanes are sliced away on the way back (:func:`aosoa_to_soa`) — round-trip
exact for every extent, ``nsites < vvl`` included.  A kernel may write
anything, even NaN, into pad lanes.

:func:`aosoa_offsets` is the index map the card's AoSoA kernels apply
(``csrc/lb_sites.cuh``: ``aosoa_index``): site ``e``, component ``c`` of a
buffer of ``ncomp`` components lies at ``(e // vvl · ncomp + c) · vvl + e %
vvl``.  :func:`aosoa_gather` reads SoA values through it; the plain
versions of the AoSoA launches read their operands that way.

The transforms are plain PyTorch (``F.pad``, ``reshape``, ``movedim``,
``contiguous``), as the reference's are plain jnp outside its Pallas bodies:
they are the boundary copies, the kernels read what they produce.

Layout axis values (``Target.layout``):

==========  ============================================================
``"soa"``   structure-of-arrays, sites contiguous per component (default)
``"aosoa"`` array-of-structures-of-arrays: vvl-site blocks outermost,
            components per block, sites-in-block innermost
==========  ============================================================
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

LAYOUTS = ("soa", "aosoa")


def aosoa_nblocks(nsites: int, vvl: int) -> int:
    """Number of AoSoA site blocks covering ``nsites`` (last one padded)."""
    if vvl <= 0:
        raise ValueError(f"vvl must be positive, got {vvl}")
    return -(-int(nsites) // int(vvl))


def soa_to_aosoa(x: torch.Tensor, vvl: int) -> torch.Tensor:
    """``(..., ncomp, nsites)`` SoA → contiguous ``(nblocks, ..., ncomp,
    vvl)`` AoSoA.

    The trailing site axis is zero-padded to a ``vvl`` multiple and split
    into blocks; blocks move to the *front* so the per-block tile ``(...,
    ncomp, vvl)`` is contiguous.  Leading axes (e.g. the ``noffsets`` axis
    of a neighbour stack) ride along inside each block.
    """
    n = int(x.shape[-1])
    nblk = aosoa_nblocks(n, vvl)
    n_pad = nblk * int(vvl)
    if n_pad != n:
        x = F.pad(x, (0, n_pad - n))
    y = x.reshape(*x.shape[:-1], nblk, int(vvl))     # (..., ncomp, nblk, vvl)
    return y.movedim(-2, 0).contiguous()             # (nblk, ..., ncomp, vvl)


def aosoa_to_soa(y: torch.Tensor, nsites: int) -> torch.Tensor:
    """Exact inverse of :func:`soa_to_aosoa`: ``(nblocks, ..., ncomp,
    vvl)`` → contiguous ``(..., ncomp, nsites)``, pad lanes sliced away."""
    x = y.movedim(0, -2)                             # (..., ncomp, nblk, vvl)
    x = x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])
    return x[..., :int(nsites)].contiguous()


def plane_to_aosoa(x: torch.Tensor, vvl: int) -> torch.Tensor:
    """Per-plane AoSoA for the windowed executor: ``(ncomp, nplanes,
    *rest)`` → ``(nplanes, nblk, ncomp, vvl)`` with ``nblk =
    prod(rest) / vvl``.

    Unlike :func:`soa_to_aosoa` this transform has **no remainder path**:
    ``vvl`` must divide the plane's site count exactly (a partial block
    would straddle two x-planes).  :func:`repro_torch.core.api.launch`
    validates this when it builds the plan; the executor zero-pads the
    halo-widened planes of a stencil field itself.
    """
    ncomp, npl = int(x.shape[0]), int(x.shape[1])
    rest_n = 1
    for s in x.shape[2:]:
        rest_n *= int(s)
    if rest_n % int(vvl):
        raise ValueError(
            f"plane site count {rest_n} is not divisible by vvl {vvl}; "
            f"the windowed AoSoA path has no remainder blocks")
    nblk = rest_n // int(vvl)
    y = x.reshape(ncomp, npl, nblk, int(vvl))
    return y.permute(1, 2, 0, 3).contiguous()        # (npl, nblk, ncomp, vvl)


def plane_from_aosoa(y: torch.Tensor, rest_shape: tuple[int, ...]
                     ) -> torch.Tensor:
    """Inverse of :func:`plane_to_aosoa`: ``(nplanes, nblk, ncomp, vvl)``
    → ``(ncomp, nplanes, *rest_shape)``."""
    npl, nblk, ncomp, vvl = (int(s) for s in y.shape)
    x = y.permute(2, 0, 1, 3).reshape(ncomp, npl, nblk * vvl)
    return x.reshape(ncomp, npl, *rest_shape)


def aosoa_offsets(sites: torch.Tensor, ncomp: int, vvl: int) -> torch.Tensor:
    """Element offsets of ``(site, component)`` in a contiguous AoSoA
    buffer of ``ncomp`` components: ``(ncomp, *sites.shape)``, component
    ``c`` of site ``e`` at ``(e // vvl · ncomp + c) · vvl + e % vvl``."""
    e = sites.to(torch.int64)
    c = torch.arange(ncomp, dtype=torch.int64, device=e.device)
    c = c.reshape(ncomp, *([1] * e.ndim))
    return ((e // vvl) * ncomp + c) * vvl + e % vvl


def aosoa_gather(blocks: torch.Tensor, sites: torch.Tensor) -> torch.Tensor:
    """The values of ``sites`` (site indices into the SoA order the AoSoA
    ``(nblk, ncomp, vvl)`` buffer holds) read through
    :func:`aosoa_offsets`: ``(ncomp, *sites.shape)``, a few components at
    a time (component ``c`` lies ``c · vvl`` past component 0), so the
    offsets of one pass stay under ``2^27`` elements."""
    nblk, ncomp, vvl = (int(s) for s in blocks.shape)
    e = sites.to(device=blocks.device, dtype=torch.int64)
    base = (e // vvl) * (ncomp * vvl) + e % vvl
    flat = blocks.reshape(-1)
    step = max(1, 2 ** 27 // max(1, base.numel()))
    parts = []
    for c0 in range(0, ncomp, step):
        c = torch.arange(c0, min(ncomp, c0 + step), device=blocks.device)
        parts.append(flat[base + (c * vvl).reshape(-1, *([1] * base.ndim))])
    return torch.cat(parts)
