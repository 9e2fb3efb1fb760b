"""Analytical performance model: predict the best strategy before running.

The re-derivation of the reference's closed-form model (main.cu:22-82):
per-strategy cost = the work shape of the engine family that realizes it,
scaled by a latency measured per unit of that work (calibrate.py), plus one
call's fixed cost:

  HBM_DIRECT      rows * trees * (depth+1)          gather steps
  SPARSE          rows * trees * (sparse depth+1)   gather steps
  ROW_TILED       rows * trees * 2^depth            leaf slots, take select
  TENSOR          rows * trees * 2^depth            leaf slots, one-hot select
  VMEM_FOREST     rows * trees * depth              fold-kernel steps
  SPLIT_FOREST    rows * trees * depth              fold-kernel steps
  RANK_MXU        rows * trees * (2^depth-1) * G    int8 node columns
  DEPTH_BUCKETED  the fold (or rank) terms summed over depth buckets

Like the reference, the model is validated against exhaustive enumeration
(autotune.enumerate_strategies) and the CLI prints "predicts
correctly/incorrectly" (main.cu:85-90).

All costs are per predict() call in seconds, for ``rows`` samples.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from tahoe_tpu.config import Strategy
from tahoe_tpu.engine import feasibility
from tahoe_tpu.forest.spec import ForestSpec
from tahoe_tpu.perf_model.calibrate import Calibration


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    compute_s: float
    memory_s: float
    dispatch_s: float

    @property
    def total(self) -> float:
        return self.compute_s + self.memory_s + self.dispatch_s


def _fold_s(rows: int, trees: int, depth: int, step_ns: float) -> float:
    return rows * trees * depth * step_ns / 1e9


def _rank_s(rows: int, trees: int, depth: int, groups: int,
            cal: Calibration) -> float:
    return rows * trees * ((1 << depth) - 1) * groups * cal.rank_node_ns / 1e9


def predict_cost(strategy: Strategy, forest: ForestSpec, rows: int,
                 cal: Calibration, platform: Optional[str] = None
                 ) -> Optional[CostBreakdown]:
    """Predicted cost, or None when infeasible (reference: acc=FLT_MAX skip,
    BaseTahoeTest.h:657-679)."""
    if feasibility.check(strategy, forest, platform) is not None:
        return None
    from tahoe_tpu.forest.compiler import rank_groups, reachable_depths

    T, D = forest.num_trees, forest.depth
    dispatch = cal.dispatch_us / 1e6

    if strategy == Strategy.HBM_DIRECT:
        compute = rows * T * (D + 1) * cal.gather_step_ns / 1e9
    elif strategy == Strategy.SPARSE:
        depth = int(reachable_depths(forest).max(initial=0))
        compute = rows * T * (depth + 1) * cal.gather_step_ns / 1e9
    elif strategy in (Strategy.ROW_TILED, Strategy.TENSOR):
        per = (cal.take_node_ns if strategy == Strategy.ROW_TILED
               else cal.onehot_node_ns)
        compute = rows * T * (1 << D) * per / 1e9
    elif strategy == Strategy.SPLIT_FOREST:
        compute = _fold_s(rows, T, D, cal.fold_step_ns)
    elif strategy == Strategy.VMEM_FOREST:
        compute = _fold_s(rows, T, D, cal.vmem_step_ns)
    elif strategy == Strategy.RANK_MXU:
        groups = rank_groups(feasibility.rank_virtual_cols(forest))
        compute = _rank_s(rows, T, D, groups, cal)
    else:  # DEPTH_BUCKETED: mirrors make_depth_bucketed_engine's choice
        from tahoe_tpu.ops.bucketed import plan_buckets

        depths = reachable_depths(forest)
        kernel = feasibility.kernel_unavailable(platform) is None
        groups = rank_groups(feasibility.rank_virtual_cols(forest))
        compute = 0.0
        for idx in plan_buckets(depths):
            d_b = int(depths[idx].max(initial=0))
            compute += (_fold_s(rows, len(idx), d_b, cal.fold_step_ns)
                        if kernel else
                        _rank_s(rows, len(idx), d_b, groups, cal))
    return CostBreakdown(compute, 0.0, dispatch)


def choose_strategy(forest: ForestSpec, rows: int,
                    cal: Optional[Calibration] = None,
                    platform: Optional[str] = None,
                    ) -> Tuple[Strategy, Dict[Strategy, Optional[CostBreakdown]]]:
    """argmin over predicted costs (main.cu:66-82 analog). Returns the pick
    and the full cost table for reporting."""
    cal = cal or Calibration.default()
    costs = {s: predict_cost(s, forest, rows, cal, platform) for s in Strategy}
    best = min(
        (s for s in Strategy if costs[s] is not None),
        key=lambda s: costs[s].total,
    )
    return best, costs
