"""The paper's own application: Ludwig's D3Q19 binary-fluid benchmark.

Grid and production sizes follow the Ludwig GPU-scaling papers ([2][3] in
the paper): ~128³ per device.  The grids are the reference's
(``repro/configs/ludwig_lb.py``); the executor and VVL are the card's:
``backend="cuda"`` (the site-kernel executor; ``BinaryFluidSim`` picks
``"cuda_windowed"`` for the fused regimes itself when given no target) and
``vvl=1``, one site a thread, the fastest of :data:`CUDA_VVLS` for the LB
kernels on the H100 (PERF.md §6).  The reference's 128 and 32 are TPU
chunk widths, which the CUDA kernels do not take.
"""
from dataclasses import dataclass

from repro_torch.core.target import CUDA_VVLS
from repro_torch.lb.params import LBParams


@dataclass(frozen=True)
class LudwigConfig:
    grid_shape: tuple
    params: LBParams = LBParams()
    vvl: int = 1
    backend: str = "cuda"

    def __post_init__(self):
        if self.vvl not in CUDA_VVLS:
            raise ValueError(f"vvl must be one of {CUDA_VVLS}, got {self.vvl}")


# paper Fig. 1 benchmark scale (single device)
BENCH = LudwigConfig(grid_shape=(64, 64, 64))

# smoke scale
SMOKE = LudwigConfig(grid_shape=(8, 8, 8))

# production slab per 256-chip pod: X sharded 16-way, Y 16-way
PRODUCTION = LudwigConfig(grid_shape=(512, 512, 256))
