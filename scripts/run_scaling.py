#!/usr/bin/env python
"""Multi-device scaling benchmark/validation.

BASELINE config 5: batch-sharded inference over several devices, target
>=85% throughput scaling efficiency. The script uses the devices JAX finds.
On GPUs it times each device count (host clock around ``block_until_ready``
on device-resident, pre-sharded rows) and reports the efficiency; on CPU
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=N``, the fold
kernel interpreted with ``TAHOE_PALLAS_INTERPRET=1``) it runs small shapes
and checks parity only, since CPU times say nothing about a card.

Multi-host usage (one process per host):
  python scripts/run_scaling.py --coordinator HOST:PORT --nprocs N --pid I
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", default=None)
    p.add_argument("--nprocs", type=int, default=None)
    p.add_argument("--pid", type=int, default=None)
    p.add_argument("--rows-per-device", type=int, default=65536)
    p.add_argument("--virtual-devices", type=int, default=None,
                   help="use at most this many devices")
    args = p.parse_args()

    import jax

    if args.nprocs and args.nprocs > 1:
        from tahoe_tpu.parallel.mesh import init_distributed

        init_distributed(args.coordinator, args.nprocs, args.pid)

    from tahoe_tpu.forest import compiler, synthetic
    from tahoe_tpu.ops import oracle
    from tahoe_tpu.parallel.mesh import make_mesh
    from tahoe_tpu.parallel.sharded import ShardedForestEngine, batch_sharded_put
    from tahoe_tpu.utils import compile_cache
    from tahoe_tpu.utils.profiling import time_call

    compile_cache.enable()
    devices = jax.devices()[: args.virtual_devices]
    n = len(devices)
    timed = devices[0].platform == "gpu"
    depth, cols = (8, 18) if timed else (4, 10)
    trees = 512 if timed else 32
    forest = synthetic.generate_forest(trees, depth, cols, seed=1)
    lev = compiler.levelize(forest)

    results = {"devices": n, "platform": devices[0].platform,
               "device_kind": devices[0].device_kind, "points": []}
    counts = [c for c in ((1, 2, 4, 8) if timed else (1, 2)) if c <= n]
    base_rate = None
    for c in counts:
        mesh = make_mesh(data=c, model=1, devices=devices[:c])
        rows = args.rows_per_device * c if timed else 32 * c
        data = synthetic.generate_data(rows, cols, seed=2)
        eng = ShardedForestEngine(lev, mesh, row_tile=128 if timed else 8,
                                  tree_tile=128 if timed else 8)
        data_sharded = batch_sharded_put(data, mesh)
        preds = np.asarray(eng.predict(data_sharded))
        err = float(np.abs(preds - oracle.predict(forest, data)).max())
        point = {"devices": c, "rows": rows, "max_err": err,
                 "correct": err <= 1e-3}
        if timed:
            rate = rows / time_call(eng.predict, data_sharded)
            point["rows_per_s"] = rate
            base_rate = base_rate or rate
            point["scaling_efficiency"] = rate / (base_rate * c)
        results["points"].append(point)
        print(json.dumps(point), flush=True)

    print(json.dumps(results), flush=True)
    return 0 if all(pt["correct"] for pt in results["points"]) else 1


if __name__ == "__main__":
    sys.exit(main())
