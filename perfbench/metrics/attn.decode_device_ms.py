"""``attn.decode_device_ms``: device time per traced step of the operations
launched inside the program's ``kronscope.attn`` ranges: the projections,
RoPE, the cache writes, the scores over the cache and the output
projection (ms).  Read as ``moe.experts_device_ms`` is."""
from pathlib import Path

from perfbench.harness import load_module

_experts = load_module(Path(__file__).with_name("moe.experts_device_ms.py"), "metric")


def read(run):
    return _experts.device_ms_per_step(run, "kronscope.attn")
