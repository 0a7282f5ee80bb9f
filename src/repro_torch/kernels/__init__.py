"""The port's kernels: plain PyTorch versions and the wrappers of the
hand-written CUDA kernels under ``repro_torch/csrc`` (built by
:mod:`repro_torch.kernels._build` at first use)."""
