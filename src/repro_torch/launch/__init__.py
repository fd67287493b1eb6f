"""Launchers: training (``python -m repro_torch.launch.train``) and serving
(``python -m repro_torch.launch.serve``, over the pure ``launch.scheduler``)."""
