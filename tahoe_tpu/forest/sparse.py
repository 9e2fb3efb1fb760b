"""Sparse (CSR-style) forest representation.

The reference's ``sparse_forest`` (Struct.h:2327-2353) stores nodes compactly:
each internal node carries a ``left_idx``; children sit at left_idx /
left_idx+1 (traversal step ``curr = left_idx + cond``, Struct.h:2244). Its
dense→sparse converter exists only as commented-out code
(BaseTahoeTest.h:728-846); here it is implemented properly: unreachable
subtrees below early leaves are pruned, which is what makes depth-20 forests
(2^21-1 dense slots/tree, Struct.h:19-21) storable at their true node count.

Arrays (SoA, one flat pool over all trees):
  values   f32 [N]   threshold / leaf value
  fids     i32 [N]
  def_left bool[N]
  is_leaf  bool[N]
  exchange bool[N]
  left_idx i32 [N]   absolute index of the left child (right = left+1)
  tree_roots i32 [T] root index per tree

Sparse inference is the deep-forest path (gather descent over the pruned
pool); shallow/complete forests are faster on the dense engines.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from tahoe_tpu.config import MISSING_EPS, Output
from tahoe_tpu.forest.spec import ForestSpec
from tahoe_tpu.ops.transform import apply_output_transform


@dataclasses.dataclass
class SparseForest:
    num_cols: int
    values: np.ndarray
    fids: np.ndarray
    def_left: np.ndarray
    is_leaf: np.ndarray
    exchange: np.ndarray
    left_idx: np.ndarray
    tree_roots: np.ndarray
    max_depth: int
    output: int = int(Output.RAW)
    global_bias: float = 0.0
    threshold: float = 0.5
    missing: float = float("nan")

    @property
    def num_trees(self) -> int:
        return int(self.tree_roots.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.values.shape[0])


def from_dense(forest: ForestSpec) -> SparseForest:
    """Dense complete-tree forest → pruned CSR forest (BFS order per tree).

    Only reachable nodes are emitted: children of early leaves are dropped
    (the reference's dense layout stores them anyway, Struct.h:19-21)."""
    values, fids = [], []
    def_left, is_leaf, exchange, left_idx = [], [], [], []
    roots = []
    max_depth = 0

    for t in range(forest.num_trees):
        base = len(values)
        roots.append(base)
        # BFS over heap indices; emit in visit order, so each internal node's
        # children land as a contiguous pair whose position is the running
        # child cursor
        queue = [(0, 0)]  # (heap index, depth)
        head = 0
        while head < len(queue):
            h, d = queue[head]
            head += 1
            max_depth = max(max_depth, d)
            leaf = bool(forest.is_leaf[t, h]) or d == forest.depth
            values.append(forest.values[t, h])
            fids.append(forest.fids[t, h])
            def_left.append(forest.def_left[t, h])
            is_leaf.append(leaf)
            exchange.append(forest.exchange[t, h])
            left_idx.append(-1)  # patched below for internal nodes
            if not leaf:
                queue.append((2 * h + 1, d + 1))
                queue.append((2 * h + 2, d + 1))
        child_cursor = base + 1
        for i in range(len(queue)):
            node = base + i
            if not is_leaf[node]:
                left_idx[node] = child_cursor
                child_cursor += 2
        assert child_cursor == base + len(queue)

    return SparseForest(
        num_cols=forest.num_cols,
        values=np.asarray(values, np.float32),
        fids=np.asarray(fids, np.int32),
        def_left=np.asarray(def_left, bool),
        is_leaf=np.asarray(is_leaf, bool),
        exchange=np.asarray(exchange, bool),
        left_idx=np.asarray(left_idx, np.int32),
        tree_roots=np.asarray(roots, np.int32),
        max_depth=max_depth,
        output=forest.output,
        global_bias=forest.global_bias,
        threshold=forest.threshold,
        missing=forest.missing,
    )


def predict_margins_np(sf: SparseForest, data: np.ndarray) -> np.ndarray:
    """Vectorized numpy CSR descent (oracle for the sparse engine)."""
    data = np.asarray(data, np.float32)
    rows = data.shape[0]
    curr = np.broadcast_to(sf.tree_roots[None, :], (rows, sf.num_trees)).copy()
    if np.isnan(np.float32(sf.missing)):
        miss_of = lambda xv: np.isnan(xv)
    else:
        miss_of = lambda xv: np.abs(xv - np.float32(sf.missing)) <= np.float32(MISSING_EPS)

    for _ in range(sf.max_depth):
        leaf = sf.is_leaf[curr]
        thr = sf.values[curr]
        fid = sf.fids[curr]
        dl = sf.def_left[curr]
        ex = sf.exchange[curr]
        xv = np.take_along_axis(data, fid, axis=1)
        cond = np.where(miss_of(xv), ~dl, xv >= thr)
        cond = np.where(ex, ~cond, cond)
        nxt = sf.left_idx[curr] + cond
        curr = np.where(leaf, curr, nxt)
    return sf.values[curr].sum(axis=1, dtype=np.float32)


def predict_np(sf: SparseForest, data: np.ndarray) -> np.ndarray:
    return apply_output_transform(
        predict_margins_np(sf, data), sf.num_trees, sf.output,
        sf.global_bias, sf.threshold, np,
    )


def sparse_tables(sf: SparseForest):
    """Device tables of a CSR forest: (values, fids, packed flags, left_idx,
    tree_roots); flags bit0 def_left, bit1 is_leaf, bit2 exchange."""
    import jax.numpy as jnp

    flags = (
        sf.def_left.astype(np.int32)
        | (sf.is_leaf.astype(np.int32) << 1)
        | (sf.exchange.astype(np.int32) << 2)
    )
    return (jnp.asarray(sf.values), jnp.asarray(sf.fids), jnp.asarray(flags),
            jnp.asarray(sf.left_idx), jnp.asarray(sf.tree_roots))


def sparse_margins(tables, data, *, max_depth: int, missing: float):
    """Raw margins of a CSR descent on device: every (row, tree) lane
    advances one level per step, masked at leaves (the reference's
    infer_one_tree_sparse vectorized, Struct.h:2217-2324). Pure function of
    (tables, data): usable under jit and shard_map."""
    import jax.numpy as jnp

    values, fids, flags, left_idx, roots = tables
    data = data.astype(jnp.float32)
    curr = jnp.broadcast_to(roots[None, :], (data.shape[0], roots.shape[0]))
    for _ in range(max_depth):
        f = flags[curr]
        dl = (f & 1).astype(bool)
        leaf = (f & 2).astype(bool)
        ex = (f & 4).astype(bool)
        xv = jnp.take_along_axis(data, fids[curr], axis=1)
        if np.isnan(np.float32(missing)):
            miss = jnp.isnan(xv)
        else:
            miss = jnp.abs(xv - jnp.float32(missing)) <= jnp.float32(MISSING_EPS)
        cond = jnp.where(miss, ~dl, xv >= values[curr])
        cond = jnp.where(ex, ~cond, cond)
        curr = jnp.where(leaf, curr, left_idx[curr] + cond.astype(jnp.int32))
    return values[curr].sum(axis=1, dtype=jnp.float32)


class SparseGatherEngine:
    """XLA CSR descent on device — the SPARSE strategy: the pruned node pool
    stays in device memory and each step gathers one level for every (row,
    tree) lane."""

    def __init__(self, sf: SparseForest):
        import jax

        self.sf = sf
        self.num_trees = sf.num_trees
        self.tables = sparse_tables(sf)
        self._predict = jax.jit(self._predict_impl)

    def _predict_impl(self, tables, data):
        import jax.numpy as jnp

        sf = self.sf
        margins = sparse_margins(tables, data, max_depth=sf.max_depth,
                                 missing=sf.missing)
        return apply_output_transform(
            margins, sf.num_trees, sf.output, sf.global_bias, sf.threshold,
            jnp,
        )

    def predict(self, data):
        import jax.numpy as jnp

        return self._predict(self.tables, jnp.asarray(data))
