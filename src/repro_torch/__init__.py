"""targetDP on PyTorch and CUDA: the port of the ``repro`` package.

The D3Q19 binary-fluid lattice-Boltzmann step (:mod:`repro_torch.lb`) and
the serving paths of a dense attention LM and a Mamba-1 LM
(:mod:`repro_torch.models`, :mod:`repro_torch.runtime`,
:mod:`repro_torch.launch.serve`) run on the
``targetDP`` core (:mod:`repro_torch.core`) through hand-written CUDA
kernels for Hopper (:mod:`repro_torch.kernels`, sources under
``repro_torch/csrc``).  Entry points run on the card unless the caller asks
for the CPU (``device="cpu"``), where every kernel's plain PyTorch version
runs instead.
"""
