"""Launchers: training (``python -m repro_torch.launch.train``), serving
(``python -m repro_torch.launch.serve``, over the pure ``launch.scheduler``)
and the production and debug meshes (``launch.mesh``)."""
