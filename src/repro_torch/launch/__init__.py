"""Launchers of the port (counterpart of ``src/repro/launch/``): the QR
service driver, ``python -m repro_torch.launch.serve_qr``, and the
training driver, ``python -m repro_torch.launch.train``."""
