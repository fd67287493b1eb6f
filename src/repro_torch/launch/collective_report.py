"""Per-site collective breakdown of one dry-run cell (hillclimb tooling).

    PYTHONPATH=src python -m repro_torch.launch.collective_report --arch X --shape Y

The port of ``repro.launch.collective_report``.  The reference weights each
collective instruction of the compiled HLO by its loops' trip counts; here
the cell's step runs once on a fake world (``dryrun.run_cell``) and every
collective call is recorded where it is made.  A site is (kind, payload
shapes, dtype, the package's call site); its bytes are its calls' payloads
summed, so the sites add up to the dry-run's ``collective_bytes``.
"""
from __future__ import annotations

import argparse
import collections


def report(arch: str, shape: str, multi_pod: bool = False, top: int = 15, *,
           device: str = "cuda", **cell_kw):
    """The cell's collective sites, most bytes first: ``(bytes, kind,
    shapes, dtype, calls, site)`` per site, all of them (the first ``top``
    printed).  ``device`` and ``cell_kw`` are ``dryrun.run_cell``'s."""
    from .dryrun import run_cell

    rec = run_cell(arch, shape, multi_pod, None, device=device, sites=True, **cell_kw)
    nbytes: dict = collections.Counter()
    calls: dict = collections.Counter()
    for s in rec["sites"]:
        key = (s["kind"], s["shape"], s["dtype"], s["site"])
        nbytes[key] += s["bytes"]
        calls[key] += 1
    rows = sorted(((b, *key[:3], calls[key], key[3]) for key, b in nbytes.items()),
                  reverse=True)
    total = sum(r[0] for r in rows)
    print(f"total collective bytes/device/step: {total/1e9:.2f} GB "
          f"({len(rows)} sites, {sum(calls.values())} calls)")
    for r in rows[:top]:
        print(f"{r[0]/1e9:7.2f}GB {r[1]:<19} n={r[4]:<5} {str(r[2])[:40]:<40} {r[3]:<9} {r[5]}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    report(a.arch, a.shape, a.multi_pod, a.top, device=a.device)


if __name__ == "__main__":
    main()
