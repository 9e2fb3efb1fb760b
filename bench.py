"""SUSY-class per-sample latency on one GPU.

    python bench.py [--rows N] [--iters N]

Prints ONE JSON line: the median µs/sample of full predicts (rows on the
device, host clock around calls that end in ``block_until_ready``) for the
fold kernel (SPLIT_FOREST), the XLA gather baseline (HBM_DIRECT) and the
int8 rank path (RANK_MXU) on a 500-tree, depth-8, 18-feature forest, each
checked against the CPU oracle, and the device they ran on. Exits non-zero
without a GPU: CPU times say nothing about the card.
"""
import argparse
import json
import sys

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=65536)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from tahoe_tpu.config import ORACLE_ATOL
    from tahoe_tpu.forest import compiler, synthetic
    from tahoe_tpu.ops import oracle
    from tahoe_tpu.ops.fold_kernel import FoldKernelEngine
    from tahoe_tpu.ops.gather_engine import GatherEngine
    from tahoe_tpu.ops.rank_engine import RankEngine
    from tahoe_tpu.utils import compile_cache
    from tahoe_tpu.utils.profiling import call_times

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py measures a GPU; JAX platform is {dev.platform}",
              file=sys.stderr)
        return 1
    compile_cache.enable()
    forest = synthetic.susy_class_forest(seed=0)
    data = synthetic.generate_data(args.rows, 18, missing_prob=0.02, seed=1)
    want = oracle.predict(forest, data)
    data_d = jax.device_put(jnp.asarray(data))

    out = {"metric": "SUSY-class (500 trees, depth 8, 18 features) "
                     "full predict", "unit": "us/sample", "rows": args.rows}
    engines = {
        "fold_kernel": FoldKernelEngine(compiler.levelize(forest)),
        "gather_baseline": GatherEngine(forest),
        "rank_int8": RankEngine(forest),
    }
    for name, eng in engines.items():
        ts = call_times(eng.predict, data_d, warmup=3, iters=args.iters)
        err = float(np.abs(np.asarray(eng.predict(data_d)) - want).max())
        if not err <= ORACLE_ATOL:
            print(f"{name}: error {err} vs oracle", file=sys.stderr)
            return 1
        us = sorted(t * 1e6 / args.rows for t in ts)
        out[f"{name}_us"] = us[len(us) // 2]
        out[f"{name}_band_us"] = [us[0], us[-1]]
        out[f"{name}_max_err"] = err
    out["value"] = out["fold_kernel_us"]
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
