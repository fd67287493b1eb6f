"""Roofline report generator: dry-run records (*.json) -> markdown tables.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir experiments/dryrun]

The port of ``repro.launch.roofline``.  Per (arch x shape x mesh): the three
roofline terms (compute / HBM / collective seconds per step, per chip, on
the H100 of ``dryrun.HW``), the dominant one, MODEL_FLOPS against the
counted FLOPs, HBM fit, and a one-line "what would move the dominant term"
note.  Also ranks cells for a hillclimb (worst roofline fraction / most
collective-bound).  A record whose ``collective_predictive`` is false (a
serving cell: the port serves on a mesh with every layer's weights gathered
whole) shows its collective term marked ``*`` and is ranked on its other
two terms.
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from .dryrun import HBM_BW, HW, PEAK_FLOPS

SUGGESTIONS = {
    ("memory_s", "train"): "fuse norm/residual f32 round-trips; bf16 boundaries",
    ("memory_s", "prefill"): "fuse attention softmax pipeline (flash kernel)",
    ("memory_s", "decode"): "quantize KV cache; fuse cache-update+attention",
    ("collective_s", "train"): "overlap FSDP gathers with compute; bf16 collectives",
    ("collective_s", "prefill"): "shard KV heads not hd; fewer norm reshards",
    ("collective_s", "decode"): "replicate small weights; batch cache collectives",
    ("compute_s", "train"): "already tensor-core-bound: raise arithmetic intensity",
    ("compute_s", "prefill"): "already tensor-core-bound",
    ("compute_s", "decode"): "already tensor-core-bound",
}


def load(dir_: str):
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def step_time(rec) -> float:
    t = rec["roofline"]
    return max(t["compute_s"], t["memory_s"], t["collective_s"])


def roofline_fraction(rec) -> float:
    """ideal/achieved step time.

    train/prefill: ideal = MODEL_FLOPS at the bf16 peak (compute roofline).
    decode: one token must stream weights+cache once from HBM — the
    bandwidth roofline: ideal = argument bytes / HBM bandwidth (a compute
    ideal is meaningless at batch*1 token granularity)."""
    return _ideal_s(rec) / max(step_time(rec), 1e-12)


def _ideal_s(rec) -> float:
    if rec["meta"]["kind"] == "decode":
        return rec["memory_analysis"].get("argument_size_in_bytes", 0) / HBM_BW
    return rec["roofline"]["model_flops_per_device"] / PEAK_FLOPS


def _predictive(rec) -> bool:
    return rec["roofline"].get("collective_predictive", True)


def _ranked_step_time(rec) -> float:
    """``step_time`` over the terms that predict the step."""
    t = rec["roofline"]
    return max(t["compute_s"], t["memory_s"], t["collective_s"] if _predictive(rec) else 0.0)


def table(recs, mesh: str) -> str:
    rows = [
        "| arch | shape | comp (ms) | HBM (ms) | coll (ms) | dominant | "
        "useful | RF | peak GB | fit |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["mesh"] != mesh:
            continue
        t = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']*1e3:.2f} | "
            f"{t['memory_s']*1e3:.2f} | {t['collective_s']*1e3:.2f}"
            f"{'' if _predictive(r) else '*'} | "
            f"{t['dominant'].removesuffix('_s')} | "
            f"{t['useful_flops_ratio']:.2f} | {roofline_fraction(r):.4f} | "
            f"{r['peak_bytes_per_device']/1e9:.2f} | "
            f"{'Y' if r['fits_hbm'] else 'N'} |"
        )
    return "\n".join(rows)


def pick_hillclimb(recs) -> list[tuple[str, str, str]]:
    """The single-pod cells with the worst roofline fraction and the most
    collective-bound one, ranked on the terms that predict a step: a cell
    whose collective term is not predictive is ranked without it and is no
    collective-bound pick."""
    single = [r for r in recs if r["mesh"] == "16x16"]
    worst_rf = min(single, key=lambda r: _ideal_s(r) / max(_ranked_step_time(r), 1e-12))
    picks = [(worst_rf["arch"], worst_rf["shape"], "worst roofline fraction")]
    coll = [r for r in single if _predictive(r)]
    if coll:
        most_coll = max(
            coll,
            key=lambda r: r["roofline"]["collective_s"] / max(step_time(r), 1e-12)
            * (1 if r["roofline"]["dominant"] == "collective_s" else 0.5),
        )
        picks.append((most_coll["arch"], most_coll["shape"], "most collective-bound"))
    return picks


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    print(f"# Roofline ({HW})\n")
    for mesh in ("16x16", "2x16x16"):
        n = sum(1 for r in recs if r["mesh"] == mesh)
        print(f"## mesh {mesh} ({n} cells)\n")
        print(table(recs, mesh))
        if any(not _predictive(r) for r in recs if r["mesh"] == mesh):
            print("\n\\* a serving layout that gathers every layer's weights whole: "
                  "not predictive")
        print()
    if any(r["mesh"] == "16x16" for r in recs):
        print("## hillclimb candidates (single-pod)\n")
        for arch, shape, why in pick_hillclimb(recs):
            print(f"* {arch} {shape} — {why}")
        print("* (third pick: most paper-representative — set manually)")


if __name__ == "__main__":
    main()
