#!/usr/bin/env python
"""Smoke test of the whole system on one NVIDIA GPU.

    python chip_smoke.py              # phases 1-4 on one card
    python chip_smoke.py --multi      # phase 5 only, on four cards

Phases (any failure exits non-zero before the final line is printed):

1. Device: the card's name and power limit (nvidia-smi), and a child
   process's JAX platform, which must be "gpu".
2. CLI protocol: a SUSY-class forest (500 trees, depth 8, 18 features) and
   65,536 rows with 2% NaN, written in the reference text formats, run
   through ``python -m tahoe_tpu.cli MODEL DATA`` as a subprocess with its
   default per-strategy isolation, before this process opens the card.
   Every strategy must report correct results or a feasibility skip.
3. Parity at real widths: ``Forest.from_files(...).predict`` for every
   strategy on five forests, each against the CPU oracle at 1e-3.
4. Kernel versus XLA: the Pallas fold kernel against the plain XLA engines
   at the SUSY shape (median of timed calls ending in block_until_ready on
   device-resident rows), and a fresh calibration for the perf model.
5. ``--multi``: the sharded engines on four cards — batch-sharded
   (data=4), tree-sharded (model=4, psum of margins) and a 2x2 mesh —
   against the one-card result and the oracle.

The last line of stdout is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
ATOL = 1e-3  # the reference's oracle tolerance (cuda_base.h:103)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi unavailable: {e}")
    if out.returncode or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# --- forests ---------------------------------------------------------------

def forests():
    """(name, ForestSpec, rows, missing sentinel) at real widths."""
    from tahoe_tpu.config import Output
    from tahoe_tpu.forest import synthetic
    from tahoe_tpu.forest.train import train_forest

    nan = float("nan")
    out = [
        ("susy", synthetic.susy_class_forest(seed=0), 65536, nan),
        # allstate-like: 130 features (scripts/run_sweep.py families)
        ("allstate130", synthetic.generate_forest(250, 8, 130, seed=1),
         16384, nan),
        ("deep13", synthetic.generate_forest(80, 13, 24, seed=1), 4096, nan),
        ("deep18_trained", train_forest(16, 18, 24, rows=2048, seed=1),
         8192, nan),
    ]
    out_flags = int(Output.AVG | Output.SIGMOID | Output.THRESHOLD)
    f = synthetic.generate_forest(200, 8, 28, missing=-999.0,
                                  output=out_flags, global_bias=0.1, seed=2)
    out.append(("sentinel_avg_sigmoid_threshold", f, 8192, -999.0))
    return out


def make_rows(spec, rows: int, missing: float, seed: int):
    from tahoe_tpu.forest import synthetic

    data = synthetic.generate_data(rows, spec.num_cols, missing_prob=0.02,
                                   missing=missing, seed=seed)
    if spec.output & 0x100:
        # THRESHOLD compares a score with > and returns 0/1: a row whose
        # score lies within f32 rounding of the threshold can round either
        # way in any summation order, so keep rows clear of it
        from tahoe_tpu.config import Output
        from tahoe_tpu.ops import oracle

        soft = spec.copy()
        soft.output = int(spec.output & ~Output.THRESHOLD)
        score = oracle.predict(soft, data)
        data = data[np.abs(score - spec.threshold) > 1e-5]
    return data


# --- phases ----------------------------------------------------------------

def phase_cli(tmp: str, out_dir: str | None) -> None:
    from tahoe_tpu.config import Strategy
    from tahoe_tpu.forest import io, synthetic

    spec = synthetic.susy_class_forest(seed=0)
    data = synthetic.generate_data(65536, 18, missing_prob=0.02, seed=1)
    mp, dp = os.path.join(tmp, "susy_model.txt"), os.path.join(tmp, "susy_data.txt")
    io.save_model(mp, spec)
    io.save_data(dp, data, missing=float("nan"))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "tahoe_tpu.cli", mp, dp, "--epochs", "10",
         "--warmup", "2"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    if out_dir:
        with open(os.path.join(out_dir, "cli_transcript.txt"), "w") as f:
            f.write(r.stdout + "\n--- stderr ---\n" + r.stderr[-20000:])
    if r.returncode:
        fail(f"CLI exit {r.returncode}: {r.stdout[-2000:]} {r.stderr[-2000:]}")
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("Using the #")]
    if len(lines) != len(Strategy):
        fail(f"CLI reported {len(lines)} strategies:\n{r.stdout[-3000:]}")
    for ln in lines:
        ok = "results are correct" in ln or (
            "DEPTH_BUCKETED" in ln and "skipped" in ln)  # uniform depth
        if not ok:
            fail(f"CLI strategy line: {ln}")
        log(f"cli: {ln}")
    for ln in r.stdout.splitlines():
        if ln.startswith(("Calibration", "Performance model", "Best", "tahoe")):
            log(f"cli: {ln}")
    log(f"phase 2 (CLI protocol) ok in {time.perf_counter() - t0:.1f}s")


def phase_parity(tmp: str) -> None:
    import jax.numpy as jnp

    from tahoe_tpu.config import Strategy
    from tahoe_tpu.engine.forest import Forest
    from tahoe_tpu.forest import io
    from tahoe_tpu.ops import oracle

    for i, (name, spec, rows, missing) in enumerate(forests()):
        t0 = time.perf_counter()
        data = make_rows(spec, rows, missing, seed=10 + i)
        mp = os.path.join(tmp, f"{name}_model.txt")
        dp = os.path.join(tmp, f"{name}_data.txt")
        io.save_model(mp, spec)
        io.save_data(dp, data, missing=missing)
        f = Forest.from_files(mp, dp, output=spec.output,
                              global_bias=spec.global_bias,
                              threshold=spec.threshold)
        data, _ = io.load_data(dp)
        want = oracle.predict(spec, data)
        x = jnp.asarray(data)
        for s in Strategy:
            reason = f.feasible(s)
            if reason is not None:
                log(f"parity {name} {s.name}: skipped ({reason})")
                continue
            got = np.asarray(f.predict(x, s))
            err = float(np.abs(got - want).max())
            log(f"parity {name} {s.name}: max err {err:.3e}")
            if not err <= ATOL:
                fail(f"{name} {s.name}: error {err} > {ATOL}")
        log(f"phase 3 {name} ({spec.num_trees} trees, depth {spec.depth}, "
            f"{spec.num_cols} features, {data.shape[0]} rows) ok in "
            f"{time.perf_counter() - t0:.1f}s")


def phase_kernel_vs_xla() -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tahoe_tpu.forest import compiler, sparse, synthetic
    from tahoe_tpu.ops import oracle
    from tahoe_tpu.ops.fold_kernel import FoldKernelEngine
    from tahoe_tpu.ops.gather_engine import GatherEngine
    from tahoe_tpu.ops.rank_engine import RankEngine
    from tahoe_tpu.ops.tensor_engine import TensorEngine
    from tahoe_tpu.perf_model import calibrate
    from tahoe_tpu.utils.profiling import call_times

    spec = synthetic.susy_class_forest(seed=0)
    rows = 65536
    data = synthetic.generate_data(rows, 18, missing_prob=0.02, seed=1)
    want = oracle.predict(spec, data)
    x = jax.device_put(jnp.asarray(data))
    lev = compiler.levelize(spec)
    engines = [
        ("fold_kernel_split (Pallas, Triton)", FoldKernelEngine(lev)),
        ("fold_kernel_vmem (Pallas, Triton)",
         FoldKernelEngine(lev, tree_tile=spec.num_trees)),
        ("gather (XLA, HBM_DIRECT)", GatherEngine(spec)),
        ("take (XLA, ROW_TILED)",
         TensorEngine(lev, select_mode="take", row_tile=4096)),
        ("rank int8 (XLA, RANK_MXU)", RankEngine(spec)),
        ("csr (XLA, SPARSE)",
         sparse.SparseGatherEngine(sparse.from_dense(spec))),
    ]
    for name, eng in engines:
        ts = call_times(eng.predict, x, warmup=3, iters=20)
        err = float(np.abs(np.asarray(eng.predict(x)) - want).max())
        if not err <= ATOL:
            fail(f"{name}: error {err}")
        us = [t * 1e6 / rows for t in ts]
        log(f"time {name}: {np.median(us):.6f} us/sample median "
            f"[{min(us):.6f}, {max(us):.6f}] over {len(us)} calls, "
            f"{rows} rows; max err {err:.2e}")
    cal = calibrate.measure()
    log(f"calibration: {json.dumps(dataclasses.asdict(cal))}")


def phase_multi() -> None:
    import jax
    import jax.numpy as jnp

    from tahoe_tpu.forest import compiler, synthetic
    from tahoe_tpu.forest.sparse import SparseGatherEngine, from_dense
    from tahoe_tpu.ops import oracle
    from tahoe_tpu.ops.fold_kernel import FoldKernelEngine
    from tahoe_tpu.ops.rank_engine import RankEngine
    from tahoe_tpu.parallel.mesh import make_mesh
    from tahoe_tpu.parallel.sharded import (
        ShardedForestEngine,
        ShardedRankEngine,
        ShardedSparseEngine,
        batch_sharded_put,
    )
    from tahoe_tpu.utils.profiling import time_call

    if len(jax.devices()) < 4:
        fail(f"--multi needs 4 devices, found {len(jax.devices())}")
    spec = synthetic.susy_class_forest(seed=0)
    rows = 65536
    data = synthetic.generate_data(rows, 18, missing_prob=0.02, seed=1)
    want = oracle.predict(spec, data)
    lev = compiler.levelize(spec)
    one_dev = jax.device_put(jnp.asarray(data), jax.devices()[0])
    single = {
        "fold": np.asarray(FoldKernelEngine(lev).predict(one_dev)),
        "rank": np.asarray(RankEngine(spec).predict(one_dev)),
        "sparse": np.asarray(
            SparseGatherEngine(from_dense(spec)).predict(one_dev)),
    }
    quarter = -(-spec.num_trees // 4)  # tree chunks that split four ways
    builders = {
        "fold": lambda m: ShardedForestEngine(lev, m, tree_tile=quarter),
        "rank": lambda m: ShardedRankEngine(spec, m, tree_tile=quarter),
        "sparse": lambda m: ShardedSparseEngine(spec, m),
    }
    for (nd, nm, label) in ((4, 1, "batch-sharded data=4"),
                            (1, 4, "tree-sharded model=4"),
                            (2, 2, "2x2 mesh")):
        mesh = make_mesh(data=nd, model=nm)
        x = batch_sharded_put(data, mesh)
        for kind, build in builders.items():
            eng = build(mesh)
            got = np.asarray(eng.predict(x))
            e_one = float(np.abs(got - single[kind]).max())
            e_ora = float(np.abs(got - want).max())
            us = time_call(eng.predict, x) * 1e6 / rows
            log(f"multi {label} {kind}: vs one card {e_one:.3e}, vs oracle "
                f"{e_ora:.3e}, {us:.6f} us/sample")
            if not (e_one <= ATOL and e_ora <= ATOL):
                fail(f"{label} {kind}: errors {e_one}, {e_ora}")


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card sharded phase")
    p.add_argument("--out", default=None,
                   help="directory for the CLI transcript")
    args = p.parse_args()

    from tahoe_tpu.engine.autotune import child_platform
    from tahoe_tpu.utils import compile_cache

    card = card_line()
    platform = child_platform()
    if platform != "gpu":
        fail(f"JAX platform is {platform}, not gpu")
    log(f"phase 1 (device) ok: platform {platform}")
    compile_cache.enable()
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    if not args.multi:
        with tempfile.TemporaryDirectory(prefix="tahoe_smoke_") as tmp:
            phase_cli(tmp, args.out)  # before this process opens the card
            import jax

            if jax.devices()[0].platform != "gpu":
                fail("this process found no GPU")
            phase_parity(tmp)
        phase_kernel_vs_xla()
    else:
        phase_multi()

    import jax

    dev = jax.devices()[0]
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
