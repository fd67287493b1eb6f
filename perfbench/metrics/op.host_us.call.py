"""``op.host_us.call``: ``op.host_us`` in a cell whose step is one call into the
op (it moves ``call_ms``)."""
from pathlib import Path

from perfbench.harness import load_module

read = load_module(Path(__file__).with_name("op.host_us.py"), "metric").read
