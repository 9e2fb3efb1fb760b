"""User-facing runtime: one Forest handle, eight strategies, one predict.

The analog of the reference's public surface (``BaseTahoeTest`` ctor +
``forest::predict`` strategy dispatch, README.md:77-85, Struct.h:245-269,
2168-2179), redesigned: no mutable globals — the strategy is an explicit
argument or chosen by the performance model.

Strategy → engine mapping (see config.Strategy for the reference kernels each
one corresponds to):

  HBM_DIRECT     → GatherEngine            (XLA level-synchronous gathers)
  ROW_TILED      → TensorEngine('take')    (row-chunked select-fold, XLA)
  TENSOR         → TensorEngine('onehot')  (one-hot feature select, XLA)
  VMEM_FOREST    → FoldKernelEngine(one tree chunk)       (Pallas, Triton)
  SPLIT_FOREST   → FoldKernelEngine(128-tree chunks)      (Pallas, Triton)
  RANK_MXU       → RankEngine              (int8 matrix products, XLA)
  DEPTH_BUCKETED → fold-kernel (or rank) buckets by reachable depth
  SPARSE         → SparseGatherEngine      (CSR descent, XLA)
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tahoe_tpu.config import Strategy
from tahoe_tpu.engine import feasibility
from tahoe_tpu.forest import compiler, io
from tahoe_tpu.forest.spec import ForestSpec
from tahoe_tpu.ops import oracle


class Forest:
    """A loaded, compiled forest plus lazily-built per-strategy engines."""

    def __init__(self, spec: ForestSpec, *, hot_swap: bool = True,
                 cluster: bool = True):
        # drop unreachable filler levels once, up front: trained forests come
        # as complete trees (reference loader materializes 2^(depth+1)-1
        # nodes, BaseTahoeTest.h:282-331) whose deep levels often hold no
        # reachable node — exact, and every engine/feasibility check then
        # sizes against the effective depth
        self.stored_depth = spec.depth
        d_eff = int(compiler.reachable_depths(spec).max(initial=0))
        if d_eff < spec.depth:
            spec = compiler.truncate_depth(spec, d_eff)
        self.spec = spec
        # The gather/packed path uses the fully compiled forest (swap +
        # exchange bits + clustering); the leveled engines fold exchange away,
        # so they consume the unswapped forest — identical predictions, fewer
        # inverted compares (see compiler.levelize).
        self.compiled, self.leveled_sw, self.packed, self.tree_order = (
            compiler.compile_forest(spec, swap=hot_swap, cluster=cluster)
        )
        self.leveled = compiler.levelize(spec)
        self._engines: Dict = {}

    # ------------------------------------------------------------------
    @classmethod
    def from_files(cls, model_path: str, data_path: Optional[str] = None,
                   *, output: int = 0, global_bias: float = 0.0,
                   threshold: float = 0.5, **kw) -> "Forest":
        """Load from the reference text model format; if a data file is given
        its num_cols and missing sentinel are adopted (the reference reads the
        sentinel from the data file header, BaseTahoeTest.h:370-371). The
        format carries no output transform: ``output`` (config.Output flags),
        ``global_bias`` and ``threshold`` give it."""
        num_cols = None
        missing = float("nan")
        if data_path is not None:
            import os

            if os.path.exists(data_path):
                _, nc, missing = _peek_data_header(data_path)
                num_cols = nc
        spec = io.load_model(model_path, num_cols=num_cols, missing=missing,
                             output=output, global_bias=global_bias,
                             threshold=threshold)
        return cls(spec, **kw)

    # ------------------------------------------------------------------
    def feasible(self, strategy: Strategy) -> Optional[str]:
        return feasibility.check(strategy, self.spec)

    def engine(self, strategy: Strategy, *, row_tile: Optional[int] = None,
               tree_tile: Optional[int] = None):
        """Build (or fetch) the engine realizing a strategy."""
        key = (strategy, row_tile, tree_tile)
        if key in self._engines:
            return self._engines[key]
        reason = self.feasible(strategy)
        if reason is not None:
            raise ValueError(f"strategy {strategy.name} infeasible: {reason}")

        if strategy == Strategy.HBM_DIRECT:
            from tahoe_tpu.ops.gather_engine import GatherEngine

            eng = GatherEngine(self.compiled)
        elif strategy == Strategy.SPARSE:
            from tahoe_tpu.forest.sparse import SparseGatherEngine, from_dense

            eng = SparseGatherEngine(from_dense(self.spec))
        elif strategy == Strategy.RANK_MXU:
            from tahoe_tpu.ops.rank_engine import RankEngine

            eng = RankEngine(self.spec, tree_chunk=tree_tile)
        elif strategy == Strategy.DEPTH_BUCKETED:
            from tahoe_tpu.ops.bucketed import make_depth_bucketed_engine

            eng = make_depth_bucketed_engine(
                self.spec,
                use_kernel=feasibility.kernel_unavailable() is None,
                row_tile=row_tile or 128, tree_tile=tree_tile or 128,
            )
        elif strategy in (Strategy.ROW_TILED, Strategy.TENSOR):
            from tahoe_tpu.ops.tensor_engine import TensorEngine

            mode = "take" if strategy == Strategy.ROW_TILED else "onehot"
            eng = TensorEngine(
                self.leveled, select_mode=mode, row_tile=row_tile or 256
            )
        else:
            from tahoe_tpu.ops.fold_kernel import FoldKernelEngine

            # VMEM_FOREST: one chunk holds the whole forest (the reference's
            # shared-forest placement); SPLIT_FOREST: 128-tree chunks with
            # partial margins summed after the kernel (split-forest)
            whole = self.spec.num_trees
            eng = FoldKernelEngine(
                self.leveled, row_tile=row_tile or 128,
                tree_tile=tree_tile or (
                    whole if strategy == Strategy.VMEM_FOREST else 128),
            )
        self._engines[key] = eng
        return eng

    # ------------------------------------------------------------------
    def predict(self, data, strategy: Strategy = Strategy.SPLIT_FOREST, **kw):
        return self.engine(strategy, **kw).predict(data)

    def predict_oracle(self, data) -> np.ndarray:
        """CPU golden model (BaseTahoeTest.h:458-487 analog)."""
        return oracle.predict(self.spec, data)


def _peek_data_header(path: str):
    with open(path, "r") as f:
        rows = int(f.readline())
        cols = int(f.readline())
        missing = float(f.readline())
    return rows, cols, missing
