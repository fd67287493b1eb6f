"""Assigned-architecture registry: one module per arch, exact public configs.

``get_config(name)`` returns the full-size ModelConfig; ``SHAPES`` is the
assigned input-shape set; ``runnable_cells()`` enumerates the 40 (arch x
shape) dry-run cells with the documented long_500k skips (DESIGN.md §7).
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass

from ..models.config import ModelConfig

ARCHS = [
    "llava_next_mistral_7b",
    "qwen2_5_32b",
    "gemma_2b",
    "qwen2_7b",
    "qwen3_4b",
    "jamba_1_5_large_398b",
    "musicgen_large",
    "deepseek_moe_16b",
    "mixtral_8x22b",
    "mamba2_130m",
]

# canonical ids (as assigned) -> module names
ALIASES = {
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "gemma-2b": "gemma_2b",
    "qwen2-7b": "qwen2_7b",
    "qwen3-4b": "qwen3_4b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "musicgen-large": "musicgen_large",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mamba2-130m": "mamba2_130m",
}


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

# long_500k needs sub-quadratic attention: run for SSM / hybrid / SWA archs,
# skip for pure full-attention archs (documented in DESIGN.md §7).
LONG_OK = {"jamba_1_5_large_398b", "mamba2_130m", "mixtral_8x22b"}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f".{mod_name}", __name__)
    return mod.CONFIG


def runnable_cells() -> list[tuple[str, str]]:
    """All (arch, shape) cells; long_500k only where sub-quadratic."""
    cells = []
    for arch in ARCHS:
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_OK:
                continue
            cells.append((arch, shape))
    return cells


def skipped_cells() -> list[tuple[str, str, str]]:
    return [
        (arch, "long_500k", "pure full attention - O(S^2) at 524k infeasible")
        for arch in ARCHS
        if arch not in LONG_OK
    ]


__all__ = [
    "ARCHS",
    "ALIASES",
    "SHAPES",
    "ShapeSpec",
    "LONG_OK",
    "get_config",
    "runnable_cells",
    "skipped_cells",
]
