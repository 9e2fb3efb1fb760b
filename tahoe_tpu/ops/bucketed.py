"""Depth-bucketed ensemble execution — strategy #7 (DEPTH_BUCKETED).

Trained forests mix shallow and deep trees but are STORED as complete trees
of the global max depth (the reference loader materializes 2^(depth+1)-1
nodes per tree, BaseTahoeTest.h:282-331). Dense level-synchronous engines pay
``2^depth`` selects per tree, so one deep tree makes every shallow tree cost
the deep price. This engine partitions trees by per-tree REACHABLE depth
(compiler.reachable_depths), truncates each bucket to its own depth
(compiler.truncate_depth — exact), and runs every bucket inside ONE jit
(fold_kernel.fold_margins and rank_engine.rank_margins are pure-functional),
summing margins before a single output transform. Work drops from
``T * max_depth`` descent steps (``T * 2^max_depth`` selects for the rank
form) to the per-bucket sums.

No reference counterpart exists (the reference's trees all run the global
depth); the closest ancestor is its similar-tree clustering (Struct.h:
1854-1891), which also groups trees so adjacent work is uniform.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tahoe_tpu.forest.compiler import (
    compact_features,
    levelize,
    reachable_depths,
    truncate_depth,
)
from tahoe_tpu.forest.spec import ForestSpec
from tahoe_tpu.ops.fold_kernel import FoldKernelEngine, fold_margins
from tahoe_tpu.ops.transform import apply_output_transform


def plan_buckets(depths: np.ndarray, max_buckets: int = 4,
                 min_count: int = 8) -> List[np.ndarray]:
    """Partition tree indices into <= max_buckets groups by effective depth.

    Exact DP over contiguous ranges of the sorted unique depths, minimizing
    Σ_b padded_count_b * 2^maxdepth_b (padded to ``min_count`` — a tiny
    bucket still costs a tree tile)."""
    uniq = np.unique(depths)
    m = len(uniq)
    counts = np.array([(depths == d).sum() for d in uniq], np.int64)

    def cost(i, j):  # bucket covering uniq[i..j]
        return max(int(counts[i : j + 1].sum()), min_count) * (1 << int(uniq[j]))

    K = min(max_buckets, m)
    INF = float("inf")
    best = [[INF] * (K + 1) for _ in range(m + 1)]
    arg = [[-1] * (K + 1) for _ in range(m + 1)]
    best[0][0] = 0
    for j in range(1, m + 1):
        for k in range(1, K + 1):
            for i in range(j):
                if best[i][k - 1] == INF:
                    continue
                c = best[i][k - 1] + cost(i, j - 1)
                if c < best[j][k]:
                    best[j][k] = c
                    arg[j][k] = i
    k = min(range(1, K + 1), key=lambda kk: best[m][kk])
    bounds = []
    j = m
    while j > 0:
        i = arg[j][k]
        bounds.append((i, j - 1))
        j, k = i, k - 1
    bounds.reverse()
    out = []
    for i, j in bounds:
        sel = np.isin(depths, uniq[i : j + 1])
        out.append(np.nonzero(sel)[0].astype(np.int64))
    return out


def subset_trees(spec: ForestSpec, idx: np.ndarray) -> ForestSpec:
    return dataclasses.replace(
        spec,
        values=spec.values[idx],
        weights=spec.weights[idx],
        fids=spec.fids[idx],
        def_left=spec.def_left[idx],
        is_leaf=spec.is_leaf[idx],
        exchange=spec.exchange[idx],
    )


class _Bucketed:
    """Shared predict of the bucketed engines: per-bucket margins from
    ``_bucket_margins`` plus the stump buckets' constant, one transform."""

    def _predict_impl(self, tables, data):
        rows = data.shape[0]
        margins = jnp.full((rows,), np.float32(self.stumps_margin))
        if self.sub:
            margins = margins + self._bucket_margins(tables, data)
        return apply_output_transform(
            margins, self.num_trees, self.output, self.global_bias,
            self.threshold, jnp,
        )

    def predict(self, data) -> jax.Array:
        return self._predict(self.tables, jnp.asarray(data))

    @property
    def bucket_plan(self) -> List[Tuple[int, int]]:
        """[(num_trees, depth)] per non-stump bucket, for reporting."""
        return [(e.num_trees, e.depth) for e in self.sub]


def _split_buckets(spec: ForestSpec, max_buckets: int):
    """Yield (bucket depth, truncated bucket spec); depth-0 buckets are
    stumps whose margin is a per-tree constant."""
    depths = reachable_depths(spec)
    for idx in plan_buckets(depths, max_buckets=max_buckets):
        d_b = int(depths[idx].max(initial=0))
        yield d_b, truncate_depth(subset_trees(spec, idx), d_b)


class DepthBucketedFoldEngine(_Bucketed):
    """Per-depth-bucket fold kernel, one jit, margins summed across buckets.
    Rows are canonicalized once: every bucket reads the same live columns."""

    def __init__(self, spec: ForestSpec, *, row_tile: int = 128,
                 tree_tile: int = 128, max_buckets: int = 4):
        self.num_trees = spec.num_trees
        self.output = spec.output
        self.global_bias = spec.global_bias
        self.threshold = spec.threshold
        spec, col_index = compact_features(spec)
        self.sub: List[FoldKernelEngine] = []
        self.stumps_margin = 0.0
        for d_b, sub in _split_buckets(spec, max_buckets):
            if d_b == 0:
                self.stumps_margin += float(sub.values[:, 0].sum())
                continue
            self.sub.append(FoldKernelEngine(
                levelize(sub), row_tile=row_tile, tree_tile=tree_tile,
                col_index=col_index, compact=False,
            ))
        self.tables = tuple(e.tables for e in self.sub)
        self._predict = jax.jit(self._predict_impl)

    def _bucket_margins(self, tables, data):
        x_t = self.sub[0]._canonicalize(data)
        margins = sum(fold_margins(e.cfg, tab, x_t)
                      for e, tab in zip(self.sub, tables))
        return margins[: data.shape[0]]


class DepthBucketedRankEngine(_Bucketed):
    """Depth buckets over the int8 rank path: ONE quantization + ONE plane
    transform shared by every bucket; each bucket's matrices are built at
    its own truncated depth."""

    def __init__(self, spec: ForestSpec, *, max_buckets: int = 4):
        from tahoe_tpu.forest.quantize import band_split, quantize
        from tahoe_tpu.ops.rank_engine import RankEngine

        spec = truncate_depth(spec, int(reachable_depths(spec).max(initial=0)))
        self.num_trees = spec.num_trees
        self.output = spec.output
        self.global_bias = spec.global_bias
        self.threshold = spec.threshold
        q, vf_base = band_split(quantize(spec))
        self.sub: List[RankEngine] = []
        self.stumps_margin = 0.0
        for d_b, sub_q in _split_buckets(q.spec, max_buckets):
            if d_b == 0:
                self.stumps_margin += float(sub_q.values[:, 0].sum())
                continue
            self.sub.append(RankEngine(
                sub_q, prequantized=(dataclasses.replace(q, spec=sub_q),
                                     vf_base)))
        self.tables = tuple(e.tables for e in self.sub)
        self._predict = jax.jit(self._predict_impl)

    def _bucket_margins(self, tables, data):
        planes = self.sub[0].planes(data)  # one shared transform
        return sum(e.margins_from_planes(tab, planes)
                   for e, tab in zip(self.sub, tables))


def make_depth_bucketed_engine(spec: ForestSpec, *, use_kernel: bool,
                               row_tile: int = 128, tree_tile: int = 128):
    """DEPTH_BUCKETED engine: fold-kernel buckets where the kernel can run
    (measured far faster than the rank path on the H100, PERF.md), int8
    rank buckets otherwise."""
    if use_kernel:
        return DepthBucketedFoldEngine(spec, row_tile=row_tile,
                                       tree_tile=tree_tile)
    return DepthBucketedRankEngine(spec)
