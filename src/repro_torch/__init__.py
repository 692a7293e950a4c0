"""PyTorch/CUDA port of the DPSNN simulator, for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package imports
nothing of it and nothing of JAX. Entry points run on ``device="cuda"``
unless the caller asks for the CPU, where every kernel wrapper takes its
plain PyTorch version (the CPU tests do that).
"""
