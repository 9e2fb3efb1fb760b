"""Exhaustive strategy enumeration — measure everything, pick the winner.

The reference's core benchmarking loop (BaseTahoeTest.h:633-710): build the
compiled forest once, run every strategy with warmup + timed epochs +
per-strategy correctness verdicts, skip infeasible ones with cost=inf, return
the argmin. Each strategy runs in its own subprocess (one JAX process on the
card at a time, see bench_worker) or in-process.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, Optional

import numpy as np

from tahoe_tpu.config import ORACLE_ATOL, Strategy
from tahoe_tpu.forest import io
from tahoe_tpu.forest.spec import ForestSpec

# reference epoch counts: 5 warmup, 50 timed for the adaptive strategies
# (BaseTahoeTest.h:43, 684-698)
WARMUP_EPOCHS = 5
TIMED_EPOCHS = 50


@dataclasses.dataclass
class StrategyResult:
    strategy: Strategy
    us_per_sample: float = float("inf")
    max_err: float = float("nan")
    correct: bool = False
    skipped_reason: Optional[str] = None
    error: Optional[str] = None
    # [min, max] of the worker's timed epochs; None for skip records
    us_band: Optional[list] = None

    @property
    def ran(self) -> bool:
        return self.skipped_reason is None and self.error is None


def enumerate_strategies(
    spec: ForestSpec,
    data: np.ndarray,
    *,
    strategies=tuple(Strategy),
    subprocess_isolation: bool = True,
    warmup: int = WARMUP_EPOCHS,
    epochs: int = TIMED_EPOCHS,
    verbose: bool = True,
) -> Dict[Strategy, StrategyResult]:
    results: Dict[Strategy, StrategyResult] = {}
    with tempfile.TemporaryDirectory(prefix="tahoe_bench_") as td:
        spec_path = os.path.join(td, "forest.npz")
        data_path = os.path.join(td, "data.npy")
        io.save_forest_npz(spec_path, spec)
        np.save(data_path, np.asarray(data, np.float32))

        for s in strategies:
            payload = _run_one(spec_path, data_path, s, warmup, epochs,
                               subprocess_isolation)
            r = StrategyResult(strategy=s)
            if "skipped" in payload:
                r.skipped_reason = payload["skipped"]
            elif "error" in payload:
                r.error = payload["error"]
            else:
                r.us_per_sample = payload["us_per_sample"]
                r.max_err = payload["max_err"]
                r.correct = payload["correct"]
                r.us_band = payload.get("us_band")
            results[s] = r
            if verbose:
                _print_result(r)
    return results


def best_strategy(results: Dict[Strategy, StrategyResult]) -> Optional[Strategy]:
    ran = [r for r in results.values() if r.ran and r.correct]
    if not ran:
        return None
    return min(ran, key=lambda r: r.us_per_sample).strategy


def child_platform() -> str:
    """``jax.default_backend()`` as a fresh child process sees it, so that
    the caller never initialises a backend (and never holds the card)."""
    out = subprocess.run(
        [sys.executable, "-c", "import jax; print(jax.default_backend())"],
        capture_output=True, text=True, timeout=600,
    )
    lines = out.stdout.split()
    if out.returncode or not lines:
        raise RuntimeError(f"platform probe failed: {out.stderr[-300:]}")
    return lines[-1]


def _run_one(spec_path, data_path, strategy, warmup, epochs,
             isolate) -> dict:
    if isolate:
        env = dict(os.environ)
        repo_root = os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "..")
        )
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [
            sys.executable, "-m", "tahoe_tpu.engine.bench_worker",
            spec_path, data_path, strategy.name, str(warmup), str(epochs),
        ]
        # Per-strategy wall cap (the reference's enumeration has none,
        # BaseTahoeTest.h:684-698); raise it for very slow strategies.
        cap = int(os.environ.get("TAHOE_BENCH_TIMEOUT_S", "1200"))
        try:
            out = subprocess.run(
                cmd, capture_output=True, text=True, env=env, timeout=cap
            )
        except subprocess.TimeoutExpired:
            return {"error": f"benchmark subprocess timed out (> {cap} s)"}
        for line in reversed(out.stdout.strip().splitlines() or [""]):
            line = line.strip()
            if line.startswith("{"):
                try:
                    return json.loads(line)
                except json.JSONDecodeError:
                    continue
        return {"error": f"worker produced no result (stderr tail: "
                         f"{out.stderr.strip()[-300:]})"}
    from tahoe_tpu.engine import bench_worker

    return bench_worker.run(spec_path, data_path, strategy.name, warmup,
                            epochs)


def _print_result(r: StrategyResult) -> None:
    """Per-strategy report in the spirit of the reference's output contract
    (strategy banner + µs/sample + correctness verdict, BaseTahoeTest.h:682-704)."""
    n = r.strategy.strategy_number
    if r.skipped_reason:
        print(f"Using the #{n} strategy ({r.strategy.name}): skipped — {r.skipped_reason}")
        return
    if r.error:
        print(f"Using the #{n} strategy ({r.strategy.name}): FAILED — {r.error}")
        return
    verdict = "correct" if r.correct else "INCORRECT"
    print(
        f"Using the #{n} strategy ({r.strategy.name}): "
        f"{r.us_per_sample:.6f} us/sample — results are {verdict} "
        f"(max err {r.max_err:.2e}, tol {ORACLE_ATOL})"
    )
