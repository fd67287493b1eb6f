"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``run.py`` runs one cell; ``harness.py`` is the run; ``cost.py`` the
operations, bytes and peaks; ``reference.py`` the plain reference and its
control; ``trace.py`` the profiler trace's reader; ``calibrate.py`` the
readings that the limits of ``correct`` were set from.  Cells, their
configurations, step kinds and metrics are files of their own under
``workloads/``, ``configs/``, ``steps/`` and ``metrics/``.
"""
