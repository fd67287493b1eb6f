"""``launch.kernels_per_call``: device kernels per call, read as
``launch.kernels_per_step`` is, in a cell whose step is one call into the op."""
from pathlib import Path

from perfbench.harness import load_module

read = load_module(Path(__file__).with_name("launch.kernels_per_step.py"), "metric").read
