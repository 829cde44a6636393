"""Hand-written Hopper kernels (csrc/*.cu) with their plain PyTorch versions.

Each ops wrapper decides by the device of its tensor: a CPU tensor takes the
plain version (ref.py), a CUDA tensor launches the kernel or raises."""
