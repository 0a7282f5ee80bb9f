"""The D3Q19 binary-fluid lattice-Boltzmann application on the port's
targetDP core."""
