"""Launchers of the port (counterpart of ``src/repro/launch/``): the token
engine's serving launcher, ``python -m repro_torch.launch.serve``, the QR
service driver, ``python -m repro_torch.launch.serve_qr``, the training
driver, ``python -m repro_torch.launch.train``, and ``spmd_qr``, the
FT-CAQR sweep with one process per lane (spawned ranks in a gloo group:
``make_lane_group``, ``ft_caqr_sweep_spmd``; ``make_lane_mesh``, the lane
mesh of ``QREngine(mesh=)``), ``mesh``, the production and QR meshes,
and ``dryrun``, every (arch x shape x mesh) cell and the ``caqr`` cell
run once on meta tensors (``python -m repro_torch.launch.dryrun``:
parameters, FLOPs and per-device bytes, no card, nothing allocated)."""
