"""``call_mfu``: ``step_mfu`` in a cell whose step is one call into the op (it
moves ``call_ms``)."""
from pathlib import Path

from perfbench.harness import load_module

read = load_module(Path(__file__).with_name("step_mfu.py"), "metric").read
