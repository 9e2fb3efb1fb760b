"""CLI driver: ``python -m tahoe_tpu.cli MODEL DATA``.

Reproduces the reference binary's run protocol and output contract
(main.cu:7-96): load model + data → calibrate hardware → analytical model
predicts a strategy → CPU oracle → baseline timing → exhaustive strategy
enumeration with per-strategy latency and correctness verdicts → report
whether the model predicted the measured best, and the speedup over the
baseline.

The baseline is the HBM_DIRECT gather engine — the role the FIL-style
dense_forest plays in the reference (BaseTahoeTest.h:549-596): the
straightforward implementation every optimized strategy is judged against.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="tahoe_tpu",
        description="Decision-forest inference engine (JAX, NVIDIA GPU)",
    )
    p.add_argument("model", help="model file (reference text format)")
    p.add_argument("data", help="data file (reference text format)")
    p.add_argument("--epochs", type=int, default=50,
                   help="timed epochs per strategy (reference: 50)")
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--no-isolation", action="store_true",
                   help="run strategies in this process instead of one "
                        "subprocess each")
    p.add_argument("--strategies", nargs="*", default=None,
                   help="subset of strategy names to enumerate")
    p.add_argument("--no-calibrate", action="store_true",
                   help="use nominal hardware constants")
    args = p.parse_args(argv)

    from tahoe_tpu.config import Strategy
    from tahoe_tpu.engine import autotune
    from tahoe_tpu.engine.forest import _peek_data_header
    from tahoe_tpu.forest import io
    from tahoe_tpu.perf_model import calibrate, model
    from tahoe_tpu.utils import compile_cache

    compile_cache.enable()

    print(f"Model: {args.model} , Data: {args.data}")

    t0 = time.perf_counter()
    _, num_cols, missing = _peek_data_header(args.data)
    spec = io.load_model(args.model, num_cols=num_cols, missing=missing)
    data, _ = io.load_data(args.data)
    print(
        f"Loaded forest: {spec.num_trees} trees, depth {spec.depth}, "
        f"{spec.num_cols} features; data: {data.shape[0]} rows "
        f"({time.perf_counter() - t0:.2f}s)"
    )

    # Isolated runs keep this process off the device: the platform and the
    # calibration (bandwidthTest analog) come from child processes, so the
    # card is free for each strategy's worker.
    isolate = not args.no_isolation
    platform = autotune.child_platform() if isolate else None
    if args.no_calibrate:
        cal = calibrate.Calibration.default()
    elif isolate:
        cal = calibrate.measure_subprocess()
    else:
        cal = calibrate.measure()
    print(
        f"Calibration ({cal.device_kind}): fold {cal.fold_step_ns*1e3:.2f} "
        f"ps/step, gather {cal.gather_step_ns*1e3:.2f} ps/step, take "
        f"{cal.take_node_ns*1e3:.2f} ps/slot, one-hot "
        f"{cal.onehot_node_ns*1e3:.2f} ps/slot, rank "
        f"{cal.rank_node_ns*1e6:.2f} fs/column, dispatch "
        f"{cal.dispatch_us:.0f} us"
    )

    predicted, costs = model.choose_strategy(spec, data.shape[0], cal,
                                             platform)
    print(f"Performance model chooses #{predicted.strategy_number} strategy "
          f"({predicted.name}).")

    strategies = (
        [Strategy[s] for s in args.strategies] if args.strategies else tuple(Strategy)
    )
    results = autotune.enumerate_strategies(
        spec, data,
        strategies=strategies,
        subprocess_isolation=isolate,
        warmup=args.warmup, epochs=args.epochs,
    )

    best = autotune.best_strategy(results)
    if best is None:
        print("No strategy produced correct results — nothing to report.")
        return 1

    if predicted == best:
        print("Performance model predicts correctly")
    else:
        print(f"Performance model predicts incorrectly "
              f"(predicted #{predicted.strategy_number} {predicted.name}, "
              f"measured best #{best.strategy_number} {best.name})")

    winner = results[best]
    # the baseline is the XLA gather descent, the role the FIL-style
    # dense_forest plays in the reference (BaseTahoeTest.h:549-596)
    baseline = results.get(Strategy.HBM_DIRECT)
    if baseline is not None and baseline.ran and best != Strategy.HBM_DIRECT:
        speedup = baseline.us_per_sample / winner.us_per_sample
        print(f"tahoe_tpu brings {speedup:.2f}x speedup over the HBM_DIRECT "
              f"gather baseline ({winner.us_per_sample:.6f} vs "
              f"{baseline.us_per_sample:.6f} us/sample).")
    print(f"Best strategy: #{best.strategy_number} {best.name} at "
          f"{winner.us_per_sample:.6f} us/sample.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
