"""Launchers of the port (twin of repro.launch): `python -m
repro_torch.launch.serve`."""
