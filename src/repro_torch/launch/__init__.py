"""Launchers: training (``python -m repro_torch.launch.train``), serving
(``python -m repro_torch.launch.serve``, over the pure ``launch.scheduler``),
the production and debug meshes (``launch.mesh``), and the dry-run tooling:
the cells (``launch.specs``), ``python -m repro_torch.launch.dryrun`` (every
cell's step on fake tensors in a fake world), ``launch.collective_report``
and ``python -m repro_torch.launch.roofline``."""
