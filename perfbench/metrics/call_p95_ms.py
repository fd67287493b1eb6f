"""``call_p95_ms``: the 95th percentile of the calls' times (ms), read as
``step_p95_ms`` is, in a cell whose step is one call into the op."""
from pathlib import Path

from perfbench.harness import load_module

read = load_module(Path(__file__).with_name("step_p95_ms.py"), "metric").read
