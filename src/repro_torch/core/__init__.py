"""Core of the PyTorch port: precision policies, operators, Lanczos,
Jacobi and the fixed-subspace solve (import the submodules directly)."""
