from repro_torch.serve.engine import ServeEngine, greedy_sample

__all__ = ["ServeEngine", "greedy_sample"]
