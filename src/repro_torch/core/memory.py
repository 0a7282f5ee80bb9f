"""Target constants — small read-only launch parameters.

Only :class:`TargetConst` is ported so far; the masked host↔target copies
and ensemble constants of the targetDP memory model wait for a later slice
(ROADMAP, queue A).
"""
from __future__ import annotations

from typing import Any

import numpy as np


class TargetConst:
    """A small read-only parameter living "close to the registers".

    The paper's CUDA implementation copies these to ``__constant__`` memory
    via ``cudaMemcpyToSymbol``.  Here the value is kept as a host numpy
    array: the plain executor turns it into a tensor on the launch's device,
    and the CUDA executors check it against the tables compiled into the
    kernels.

    ``TargetConst`` values hash by content so they participate in the launch
    plan cache key: re-binding an equal constant reuses the plan.
    """

    __slots__ = ("value", "_key")

    def __init__(self, value: Any):
        arr = np.asarray(value)
        self.value = arr
        self._key = (arr.shape, str(arr.dtype), arr.tobytes())

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, TargetConst) and self._key == other._key

    def __repr__(self):
        return f"TargetConst(shape={self.value.shape}, dtype={self.value.dtype})"
