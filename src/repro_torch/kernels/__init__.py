"""Hand-written Hopper kernels of the port (counterpart of
``src/repro/kernels/``): K1 ``panel_qr``, K2 ``wy_apply``, K3
``stacked_qr``, K4 ``stacked_apply``, K5 ``panel_qr_apply`` (the fused
leaf) and K6 ``fused_panel`` (the whole-panel megakernel) in CUDA C++
under ``csrc/``, each beside its plain PyTorch version, routed by ``ops``.
Importing this package builds nothing; ``build`` compiles the sources at
first use. ``autotune`` times the bit-neutral knobs of K2 and K4 on the
card and keeps the winners in a JSON cache keyed by
``backend.backend_fingerprint()``.
"""
