"""Plain PyTorch versions of the residual Gram kernels (fp32 contract).

Twins of repro.kernels.gram.ref.  The CPU path of kernels.gram.ops and the
yardstick the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch

__all__ = ["gram_ref", "row_gram_ref"]


def gram_ref(r: torch.Tensor) -> torch.Tensor:
    """(D, N) -> (D, D) = R @ R.T, fp32 accumulation."""
    r32 = r.to(torch.float32)
    return r32 @ r32.T


def row_gram_ref(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(N,), (D, N) -> (D,) = R @ v, fp32 accumulation."""
    return r.to(torch.float32) @ v.to(torch.float32)
