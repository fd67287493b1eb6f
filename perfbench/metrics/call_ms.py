"""``call_ms``: the mean time of one call (ms), read as ``step_ms`` is, in a cell
whose step is one call into the op: host-bound, so it keeps a bound of its own."""
from pathlib import Path

from perfbench.harness import load_module

read = load_module(Path(__file__).with_name("step_ms.py"), "metric").read
