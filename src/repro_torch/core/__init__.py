"""The ICOA solver in PyTorch: ensemble algebra, covariance, the CovState
solve state and the sweep engines (twins of repro.core)."""
