#!/usr/bin/env python
"""Per-device memory of the JAX reference's per-sample mesh backward.

    PYTHONPATH=src python tools/reference_mesh_memory.py [--batch 2 4] [--slabs 1 4]

The call is ``chip_smoke.py``'s mesh-measure winner (phase 12): gp16's
per-sample problem (six 16 x 16 factors per sample, 16 rows, K = 16^6) on a
(data, model) = (2, 2) mesh, the forward rounds and their VJP into x and
every factor, f32.  The reference (``repro.core.distributed``, XLA
backend) is lowered on four forced host devices from shapes alone and
compiled; ``compiled.memory_analysis()`` gives one device's argument,
output and temporary bytes, which the port's per-rank
``torch.cuda.max_memory_allocated`` over the same call is held against.
Compiles only: no array of the problem is allocated.  Prints one JSON line
per (batch, n_slabs).
"""
from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--slabs", type=int, nargs="+", default=[1, 4])
    args = ap.parse_args(argv)
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.core import distributed as JD

    mesh = jax.make_mesh((2, 2), ("data", "model"))
    ps, m = (16,) * 6, 16
    k = 16 ** 6
    x_sh = NamedSharding(mesh, P(None, "data", "model"))
    rep = NamedSharding(mesh, P())
    with jax.set_mesh(mesh):
        for b in args.batch:
            for n in args.slabs:
                def fwd_bwd(x, fs, ct, n=n):
                    y, vjp = jax.vjp(lambda a, f: JD.run_batched_distributed_rounds(
                        a, f, mesh, backend="xla", n_slabs=n), x, fs)
                    return y, vjp(ct)

                x = jax.ShapeDtypeStruct((b, m, k), jnp.float32, sharding=x_sh)
                fs = tuple(jax.ShapeDtypeStruct((b, p, p), jnp.float32, sharding=rep)
                           for p in ps)
                mem = jax.jit(fwd_bwd).lower(x, fs, x).compile().memory_analysis()
                gib = 2 ** 30
                print(json.dumps({
                    "case": "gp16-mesh-fwd-bwd", "mesh": [2, 2], "batch": b, "n_slabs": n,
                    "argument_gib": mem.argument_size_in_bytes / gib,
                    "output_gib": mem.output_size_in_bytes / gib,
                    "temp_gib": mem.temp_size_in_bytes / gib,
                    "total_gib": (mem.argument_size_in_bytes + mem.output_size_in_bytes
                                  + mem.temp_size_in_bytes) / gib,
                    "device": "per device (CPU host devices, compiled by XLA)",
                }), flush=True)


if __name__ == "__main__":
    main()
