"""Hardware calibration microbenchmarks.

The analog of the reference's adapted NVIDIA ``bandwidthTest`` probe
(bandwidthTest.h:110-381): measure the machine once, feed the analytical model
(main.cu:29-32 uses one bandwidth number plus fixed ratios). XLA-compiled
programs are not predictable from hand-counted byte traffic, so the probes
are *strategy-family microbenchmarks* (SURVEY.md §7): one small forest run
through each engine family, timed with ``block_until_ready`` on
device-resident inputs, yielding per-unit-of-work latencies that the cost
model scales to full forest shapes.

``Calibration.default()`` holds one such measurement, with the card it was
taken on; ``measure()`` takes a fresh one on the machine it runs on.
"""
from __future__ import annotations

import dataclasses
import json
import os


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-unit latencies in nanoseconds + the call's fixed cost."""

    # fold kernel, SPLIT_FOREST placement: ns per (row, tree, level) step
    fold_step_ns: float
    # fold kernel, VMEM_FOREST placement (one tree chunk per program)
    vmem_step_ns: float
    # XLA gather descent (HBM_DIRECT, SPARSE): ns per (row, tree, level)
    gather_step_ns: float
    # XLA select-fold, take mode (ROW_TILED): ns per (row, leaf slot)
    take_node_ns: float
    # XLA select-fold, one-hot mode (TENSOR): ns per (row, leaf slot)
    onehot_node_ns: float
    # XLA int8 rank path (RANK_MXU): ns per (row, node, plane group)
    rank_node_ns: float
    # fixed cost of one jitted predict call
    dispatch_us: float
    device_kind: str = "unknown"

    @staticmethod
    def default() -> "Calibration":
        # measure() on an NVIDIA H100 80GB HBM3 at a 400 W power limit
        # (chip_smoke.py phase 4)
        return Calibration(
            fold_step_ns=0.006947,
            vmem_step_ns=0.008527,
            gather_step_ns=0.011140,
            take_node_ns=0.003550,
            onehot_node_ns=0.012705,
            rank_node_ns=0.004440,
            dispatch_us=141.9,
            device_kind="NVIDIA H100 80GB HBM3",
        )


def measure() -> Calibration:
    """Time each engine family on the SUSY-class forest (500 trees, depth 8,
    18 features) at 65,536 rows: big enough that the call's fixed cost is a
    small part of each time (about a minute on a GPU)."""
    import jax
    import jax.numpy as jnp

    from tahoe_tpu.engine.feasibility import kernel_unavailable
    from tahoe_tpu.forest import compiler, synthetic
    from tahoe_tpu.ops.gather_engine import GatherEngine
    from tahoe_tpu.ops.rank_engine import RankEngine
    from tahoe_tpu.ops.tensor_engine import TensorEngine
    from tahoe_tpu.utils.profiling import time_call

    forest = synthetic.susy_class_forest(seed=5)
    trees, depth, cols, rows = forest.num_trees, forest.depth, 18, 65536
    data_d = jax.device_put(jnp.asarray(
        synthetic.generate_data(rows, cols, missing_prob=0.02, seed=6)))
    lev = compiler.levelize(forest)
    steps = rows * trees * depth
    leaf_slots = rows * trees * (1 << depth)

    null = jax.jit(lambda v: v + 1.0)
    dispatch_s = time_call(null, jnp.ones((8, 128), jnp.float32), iters=20)

    def per(eng, units):
        return time_call(eng.predict, data_d, iters=5) / units * 1e9

    fold_ns = vmem_ns = float("inf")
    if kernel_unavailable() is None:
        from tahoe_tpu.ops.fold_kernel import FoldKernelEngine

        fold_ns = per(FoldKernelEngine(lev), steps)
        vmem_ns = per(FoldKernelEngine(lev, tree_tile=trees), steps)
    return Calibration(
        fold_step_ns=fold_ns,
        vmem_step_ns=vmem_ns,
        gather_step_ns=per(GatherEngine(forest), rows * trees * (depth + 1)),
        take_node_ns=per(TensorEngine(lev, select_mode="take"), leaf_slots),
        onehot_node_ns=per(TensorEngine(lev, select_mode="onehot"),
                           leaf_slots),
        rank_node_ns=per(RankEngine(forest),
                         rows * trees * ((1 << depth) - 1)),
        dispatch_us=dispatch_s * 1e6,
        device_kind=jax.devices()[0].device_kind,
    )


def measure_subprocess() -> Calibration:
    """Run the probes in a child process and parse its JSON line, so that
    the caller never initialises a backend itself (the CLI parent keeps the
    card free for its per-strategy workers)."""
    import subprocess
    import sys

    env = dict(os.environ)
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "tahoe_tpu.perf_model.calibrate"],
        capture_output=True, text=True, env=env, timeout=1800,
    )
    for line in reversed(out.stdout.strip().splitlines() or [""]):
        if line.strip().startswith("{"):
            return Calibration(**json.loads(line))
    raise RuntimeError(
        f"calibration subprocess failed: {out.stderr.strip()[-300:]}"
    )


if __name__ == "__main__":
    from tahoe_tpu.utils import compile_cache

    compile_cache.enable()
    print(json.dumps(dataclasses.asdict(measure())), flush=True)
