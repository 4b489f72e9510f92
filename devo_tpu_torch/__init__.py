"""devo_tpu_torch: the DEVO tracking engine in PyTorch, for NVIDIA GPUs.

The counterpart of the JAX package `devo_tpu`, module for module: plain
tensor code in PyTorch, and the two-level patch correlation as a CUDA C++
kernel written for Hopper (`csrc/corr.cu`, bound in `ops/corr_cuda.py`).
The package imports neither jax nor devo_tpu.
"""
__version__ = "0.1.0"
