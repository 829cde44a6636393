"""Residual covariance estimation (paper eq. 14) — full and alpha-compressed.

Residuals are held as R (D, N), one row per agent; the covariance is the
uncentered second moment A_ij = (1/N) r_i^T r_j.  With `use_kernel` the
product runs through kernels.gram (fp32 accumulation, cast back to the
residual dtype) — the hand-written CUDA kernel on a CUDA tensor.  A
leading Monte-Carlo trial axis (B, D, N) gives one estimate per trial (the
batched kernel).

`subsampled_covariance` is the Minimax-Protection transport (Sec 4.1): only
m = ceil(N / alpha) instances cross the wire, so the off-diagonals come from
that subsample while the diagonal (local, free) stays exact.  The subsample
is `prng.permutation(key, N)[:m]`, the JAX package's draw bit for bit; a
(B, 2) key gives one subsample per trial, (B, m).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import prng

__all__ = ["gram", "residual_covariance", "spliced_gram", "subsample_size",
           "subsample_indices", "subsampled_gram", "subsampled_covariance",
           "take_cols"]


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


def subsample_indices(key: torch.Tensor, n: int, alpha: float) -> torch.Tensor:
    """ceil(N / alpha) instance indices drawn without replacement: (m,) for
    one key (2,), (B, m) for a key per trial (B, 2)."""
    return prng.permutation(key, n)[..., :subsample_size(n, alpha)]


def take_cols(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The columns idx of x's last axis: idx (m,) is shared by all of x's
    rows; idx (B, m) is trial b's for x (B, ...)."""
    if idx.dim() == 1:
        return x[..., idx]
    index = idx.reshape(idx.shape[0], *([1] * (x.dim() - 2)), idx.shape[-1])
    return torch.gather(x, -1, index.expand(*x.shape[:-1], idx.shape[-1]))


def spliced_gram(sub: torch.Tensor, exact_diag: torch.Tensor,
                 use_kernel: bool = False) -> torch.Tensor:
    """The Sec 4.1 splice: off-diagonals from the subsample rows (..., D, m),
    the diagonal replaced by the exact local variances (..., D) — the one
    place the CovState build, the dense objective and the record share."""
    a0 = gram(sub, use_kernel=use_kernel)
    return (a0 - torch.diag_embed(torch.diagonal(a0, dim1=-2, dim2=-1))
            + torch.diag_embed(exact_diag))


def subsampled_gram(residuals: torch.Tensor, idx: Optional[torch.Tensor],
                    use_kernel: bool = False) -> torch.Tensor:
    """A0 from given subsample indices: off-diagonals estimated from the
    subsample, diagonal exact (the paper's delta_ii = 0).  `idx is None`
    means full transmission: the exact A."""
    if idx is None:
        return gram(residuals, use_kernel=use_kernel)
    exact_diag = torch.sum(residuals * residuals, dim=-1) / residuals.shape[-1]
    return spliced_gram(take_cols(residuals, idx), exact_diag,
                        use_kernel=use_kernel)


def subsampled_covariance(key: torch.Tensor, residuals: torch.Tensor,
                          alpha: float, use_kernel: bool = False,
                          idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A0 with off-diagonals from an N/alpha subsample drawn from `key`
    (unless `idx` is given) and the exact local diagonal."""
    if idx is None:
        idx = subsample_indices(key, residuals.shape[-1], alpha)
    return subsampled_gram(residuals, idx, use_kernel=use_kernel)
