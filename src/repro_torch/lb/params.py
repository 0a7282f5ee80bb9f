"""Physical parameters of the binary-fluid model.

Defaults follow the symmetric-quench (spinodal decomposition) setup used in
Ludwig's binary benchmark family: double-well potential
V(φ) = -A/2 φ² + B/4 φ⁴ with A=B (minima at φ=±1), interfacial term κ/2|∇φ|²,
relaxation times τ (viscosity ν=(τ-1/2)/3) and τ_φ (mobility M=Γ(τ_φ-1/2)).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class LBParams:
    A: float = 0.0625
    B: float = 0.0625
    kappa: float = 0.04
    tau: float = 1.0
    tau_phi: float = 1.0
    gamma: float = 1.0
    rho0: float = 1.0

    @property
    def viscosity(self) -> float:
        return (self.tau - 0.5) / 3.0

    @property
    def interface_width(self) -> float:
        return (2.0 * self.kappa / self.A) ** 0.5

    @property
    def surface_tension(self) -> float:
        return (8.0 * self.kappa * self.A / 9.0) ** 0.5

    def as_kwargs(self) -> dict:
        return dict(A=self.A, B=self.B, kappa=self.kappa, tau=self.tau,
                    tau_phi=self.tau_phi, gamma=self.gamma)
