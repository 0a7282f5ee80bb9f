"""The paper's example site kernels on the targetDP core: ``scale``,
``saxpy`` and ``site_pos``.

``scale`` is the paper's own §III-C example (``examples/quickstart.py``:
scale a field by a constant); ``saxpy`` is its two-field companion, and
``site_pos`` (``y = x + site index``) is a position-dependent kernel, the
role of ``KernelSpec.site_index`` (the reference's
``tests/test_tdp_core.py::test_site_index_kernel``).  Every field is
pointwise and of any component count.

Each plain body (torch ops over the trailing site axis) is what the
``"torch"`` executor runs and, on CPU tensors, what the ``"cuda"`` executor
runs; it names its CUDA twin in ``csrc/example_sites.cuh`` in
``__cuda_site__``, which ``"cuda"`` launches on CUDA tensors through
``csrc/tdp_gathered_example.cu``.  Both round alike: the twins are bit-equal
to these bodies.

In bfloat16 the bodies round as the reference's Pallas bodies do: a scalar
``a`` is weak, rounded to bfloat16 before it multiplies
(:func:`repro_torch.kernels.bf16.weak`), so ``saxpy`` rounds twice in
bfloat16; an array ``a`` is an operand of its own dtype (a float32 one
makes the arithmetic float32 until the store), as the reference's
``_canonicalize_consts`` makes it; the result is stored in x's dtype; the
``int32`` site index goes to bfloat16 before the add.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import FieldSpec, KernelSpec

from . import bf16


def _const(a, x):
    """``a`` as a body over ``x`` takes it: a scalar weak in x's dtype, an
    array a tensor of its own dtype (float64 as float32, as JAX without
    x64 takes it)."""
    if isinstance(a, (np.ndarray, torch.Tensor)):
        a = torch.as_tensor(a, device=x.device)
        return a.float() if a.dtype == torch.float64 else a
    return bf16.weak(a, x.dtype)


def scale_site(x, a=1.0):
    """``a · x``: the paper's example."""
    return (_const(a, x) * x).to(x.dtype)


def saxpy_site(x, y, a=1.0):
    """``a · x + y``, two roundings (no fused multiply-add)."""
    return (_const(a, x) * x + y).to(x.dtype)


def site_pos_site(x, site_idx):
    """``x + site index``: ``site_idx`` is the ``int32`` ``(nsites,)``
    tensor a ``site_index=True`` launch passes last (in bfloat16 rounded
    to bfloat16 first, as PyTorch and the reference both convert it)."""
    return x + site_idx


for _fn, _site in ((scale_site, "scale"), (saxpy_site, "saxpy"),
                   (site_pos_site, "site_pos")):
    _fn.__cuda_site__ = _site

SCALE_SPEC = KernelSpec(scale_site, fields=(FieldSpec(name="x"),),
                        consts=("a",), name="scale")
SAXPY_SPEC = KernelSpec(saxpy_site,
                        fields=(FieldSpec(name="x"), FieldSpec(name="y")),
                        consts=("a",), name="saxpy")
SITE_POS_SPEC = KernelSpec(site_pos_site, fields=(FieldSpec(name="x"),),
                           site_index=True, name="site_pos")

#: every example spec, by the name of its CUDA site function
SPECS = {"scale": SCALE_SPEC, "saxpy": SAXPY_SPEC, "site_pos": SITE_POS_SPEC}
