"""PyTorch and CUDA port of ``repro`` for NVIDIA Hopper.

Laid out module for module like ``repro``.  Imports ``torch`` and never
``jax``; kernels are hand-written CUDA C++ under ``csrc/``, built at first
use.  Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
