from repro_torch.checkpoint import io

__all__ = ["io"]
