"""Benchmark worker: time ONE strategy, in-process or as a fresh process.

A process per strategy keeps one JAX process on the card at a time: the CLI
parent stays off the device while each worker holds it. Timing is the host
clock around predicts on device-resident rows, each ending in
``block_until_ready`` (``epochs`` timed calls after ``warmup``, median
reported — the reference's warmup + timed epochs, BaseTahoeTest.h:684-698).

Protocol: argv = forest.npz data.npy strategy_name warmup epochs;
stdout = one JSON line {us_per_sample, us_band, correct, max_err, rows}.
"""
from __future__ import annotations

import json
import sys

import numpy as np


def run(spec_path: str, data_path: str, strategy_name: str,
        warmup: int, epochs: int) -> dict:
    import jax
    import jax.numpy as jnp

    from tahoe_tpu.config import ORACLE_ATOL, Strategy
    from tahoe_tpu.engine.forest import Forest
    from tahoe_tpu.forest import io
    from tahoe_tpu.utils.profiling import call_times

    spec = io.load_forest_npz(spec_path)
    data = np.load(data_path)
    strategy = Strategy[strategy_name]

    forest = Forest(spec)
    reason = forest.feasible(strategy)
    if reason is not None:
        return {"skipped": reason}

    eng = forest.engine(strategy)
    data_d = jax.device_put(jnp.asarray(data, jnp.float32))
    ts = call_times(eng.predict, data_d, warmup=warmup, iters=max(epochs, 1))
    us = [t * 1e6 / data.shape[0] for t in ts]

    preds = eng.predict(data_d)
    want = forest.predict_oracle(data)
    err = float(np.abs(np.asarray(preds) - want).max())
    return {
        "us_per_sample": float(np.median(us)),
        "us_band": [min(us), max(us)],
        "max_err": err,
        "correct": bool(err <= ORACLE_ATOL),
        "rows": int(data.shape[0]),
    }


def main(argv):
    from tahoe_tpu.utils import compile_cache

    compile_cache.enable()
    spec_path, data_path, strategy_name, warmup, epochs = argv[:5]
    try:
        result = run(spec_path, data_path, strategy_name, int(warmup),
                     int(epochs))
    except Exception as e:  # report failures as data, not tracebacks
        result = {"error": f"{type(e).__name__}: {e}"}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
