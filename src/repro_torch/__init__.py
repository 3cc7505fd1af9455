"""PyTorch/CUDA port of the FT-CAQR system (counterpart of ``src/repro/``).

The same module layout as the JAX package; the four kernels of the
windowed sweep (K1-K4) are CUDA C++ for Hopper under ``csrc/``. Entry
points that make tensors from numpy default to the GPU and raise without
one unless asked for ``device="cpu"``. Imports neither JAX nor ``repro``.
"""
