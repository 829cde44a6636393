"""Residual covariance estimation (paper eq. 14), the alpha = 1 slice.

Residuals are held as R (D, N), one row per agent; the covariance is the
uncentered second moment A_ij = (1/N) r_i^T r_j.  With `use_kernel` the
product runs through kernels.gram (fp32 accumulation, cast back to the
residual dtype) — the hand-written CUDA kernel on a CUDA tensor.  A
leading Monte-Carlo trial axis (B, D, N) gives one estimate per trial (the
batched kernel).

The alpha > 1 subsampled estimate (`subsample_indices`, `spliced_gram`, a
subsample `idx`) waits for Minimax Protection (ROADMAP A8).
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["gram", "residual_covariance", "subsample_size", "subsampled_gram"]


def gram(r: torch.Tensor, use_kernel: bool = False) -> torch.Tensor:
    """(..., D, N) -> (..., D, D) Gram matrix R R^T / N."""
    if use_kernel:
        from repro_torch.kernels.gram import ops as gram_ops

        return (gram_ops.gram(r) / r.shape[-1]).to(r.dtype)
    return (r @ r.mT) / r.shape[-1]


def residual_covariance(residuals: torch.Tensor,
                        use_kernel: bool = False) -> torch.Tensor:
    """Full-data covariance estimate A (paper eq. 14)."""
    return gram(residuals, use_kernel=use_kernel)


def subsample_size(n: int, alpha: float) -> int:
    """ceil(N / alpha), floored at 2 so a covariance is defined: how many
    instances rate alpha transmits (also the byte accounting's m)."""
    return max(2, int(-(-n // alpha)))


def subsampled_gram(residuals: torch.Tensor, idx: Optional[torch.Tensor],
                    use_kernel: bool = False) -> torch.Tensor:
    """A0 from given subsample indices; `idx is None` means full
    transmission, the exact A — the only case of this slice."""
    if idx is not None:
        raise NotImplementedError(
            "subsampled covariance (alpha > 1) waits for ROADMAP A8")
    return gram(residuals, use_kernel=use_kernel)
