"""Plain PyTorch versions of the residual Gram kernels (fp32 contract).

Twins of repro.kernels.gram.ref.  The CPU path of kernels.gram.ops and the
yardstick the CUDA kernels are held against on the card.  The `_batched`
versions carry a leading Monte-Carlo trial axis (B, ...)."""
from __future__ import annotations

import torch

__all__ = ["gram_ref", "row_gram_ref", "gram_batched_ref",
           "row_gram_batched_ref"]


def gram_ref(r: torch.Tensor) -> torch.Tensor:
    """(D, N) -> (D, D) = R @ R.T, fp32 accumulation."""
    r32 = r.to(torch.float32)
    return r32 @ r32.T


def row_gram_ref(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(N,), (D, N) -> (D,) = R @ v, fp32 accumulation."""
    return r.to(torch.float32) @ v.to(torch.float32)


def gram_batched_ref(r: torch.Tensor) -> torch.Tensor:
    """(B, D, N) -> (B, D, D) = R_b @ R_b.T per trial, fp32 accumulation."""
    r32 = r.to(torch.float32)
    return r32 @ r32.mT


def row_gram_batched_ref(v: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """(B, N) or (N,) shared by every trial, (B, D, N) -> (B, D) = R_b @ v_b,
    fp32 accumulation."""
    v32 = v.to(torch.float32).expand(r.shape[0], r.shape[2])
    return (r.to(torch.float32) @ v32[..., None])[..., 0]
