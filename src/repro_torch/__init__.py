"""PyTorch/CUDA port of the FT-CAQR system (counterpart of ``src/repro/``).

The same module layout as the JAX package: ``core`` (the windowed sweep
and recovery), ``ft`` (the failure model, the sweep state machine and the
scheduled REBUILD driver) and ``kernels``, whose six kernels (K1-K4 of the
stepped sweep, the fused K5 and K6) are CUDA C++ for Hopper under
``csrc/``. Entry points that make tensors from numpy default to the GPU
and raise without one unless asked for ``device="cpu"``. Imports neither
JAX nor ``repro``.
"""
