"""Pure-jnp gather-descent engine (HBM_DIRECT strategy).

The rendition of the reference's global-memory strategy 1
(infer_adaptive_reorg_*, Struct.h:1196-1240): node tables stay in device
memory and XLA schedules the gathers. Where a CUDA thread chases one (row, tree)
pointer, here *all* (row, tree) lanes advance one level per step —
level-synchronous masked descent — with the per-level node reads expressed as
gathers (``take_along_axis``). Works on any backend at any depth; it is the
jit-compatible correctness baseline the kernel and tensor engines are
measured against, and plays the role of the reference's FIL-style dense baseline
(dense_forest, Struct.h:802-861) in speedup reporting.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from tahoe_tpu.config import MISSING_EPS
from tahoe_tpu.forest.spec import ForestSpec
from tahoe_tpu.ops.transform import apply_output_transform


def missing_mask(xv, missing: float):
    """Vectorized missing test (Struct.h:380-383 sentinel / 518 NaN path)."""
    if np.isnan(np.float32(missing)):
        return jnp.isnan(xv)
    return jnp.abs(xv - jnp.float32(missing)) <= jnp.float32(MISSING_EPS)


class GatherEngine:
    """Device arrays + a jitted predict for one ForestSpec."""

    def __init__(self, forest: ForestSpec):
        self.depth = forest.depth
        self.num_trees = forest.num_trees
        self.num_cols = forest.num_cols
        self.output = forest.output
        self.global_bias = forest.global_bias
        self.threshold = forest.threshold
        self.missing = forest.missing

        # Node-major tables [N, T]: the minor dim runs over trees so each
        # level's gather reads a dense [2^d, T] stripe — the reference's
        # coalesced "reorg" layout (Struct.h:1911-1923).
        # Pack the three flag bits into one i32 word to halve gather traffic:
        # bit0 def_left, bit1 is_leaf, bit2 exchange.
        flags = (
            forest.def_left.astype(np.int32)
            | (forest.is_leaf.astype(np.int32) << 1)
            | (forest.exchange.astype(np.int32) << 2)
        )
        # tables are a jit argument, not constants baked into the program
        self.tables = (
            jnp.asarray(forest.values.T),
            jnp.asarray(forest.fids.T),
            jnp.asarray(flags.T),
        )
        self._predict = jax.jit(self._predict_impl)

    # ------------------------------------------------------------------
    def _predict_impl(self, tables, data):
        margins = self._margins_impl(tables, data)
        return apply_output_transform(
            margins, self.num_trees, self.output, self.global_bias,
            self.threshold, jnp,
        )

        return jax.lax.fori_loop(
            0, k, body, jnp.zeros(data.shape[0], jnp.float32)
        )

    def _margins_impl(self, tables, data):
        values, fids, flags_t = tables
        data = data.astype(jnp.float32)
        rows = data.shape[0]
        curr = jnp.zeros((rows, self.num_trees), dtype=jnp.int32)

        # Unrolled static-depth descent: each step gathers this level's nodes
        # for every (row, tree) lane and advances curr = 2*curr+1+cond, masked
        # by is_leaf — the vectorized form of Struct.h:365-403.
        for _ in range(self.depth):
            thresh = jnp.take_along_axis(values, curr, axis=0)
            fid = jnp.take_along_axis(fids, curr, axis=0)
            flags = jnp.take_along_axis(flags_t, curr, axis=0)
            def_left = (flags & 1).astype(bool)
            node_leaf = (flags & 2).astype(bool)
            exch = (flags & 4).astype(bool)

            xv = jnp.take_along_axis(data, fid, axis=1)
            miss = missing_mask(xv, self.missing)
            cond = jnp.where(miss, ~def_left, xv >= thresh)
            cond = jnp.where(exch, ~cond, cond)
            nxt = 2 * curr + 1 + cond.astype(jnp.int32)
            curr = jnp.where(node_leaf, curr, nxt)

        leaf_vals = jnp.take_along_axis(values, curr, axis=0)
        return leaf_vals.sum(axis=1, dtype=jnp.float32)

    # ------------------------------------------------------------------
    def predict(self, data) -> jax.Array:
        return self._predict(self.tables, jnp.asarray(data))

    def margins(self, data):
        return self._margins_impl(self.tables, jnp.asarray(data))


@partial(jax.jit, static_argnames=("depth", "missing_is_nan"))
def gather_margins(values_nm, fids_nm, flags_nm, data, *, depth: int,
                   missing: float = float("nan"), missing_is_nan: bool = True):
    """Functional form used by the distributed layer (shard_map-friendly):
    node-major tables in, margins out, no class state."""
    rows = data.shape[0]
    num_trees = values_nm.shape[1]
    curr = jnp.zeros((rows, num_trees), dtype=jnp.int32)
    for _ in range(depth):
        thresh = jnp.take_along_axis(values_nm, curr, axis=0)
        fid = jnp.take_along_axis(fids_nm, curr, axis=0)
        flags = jnp.take_along_axis(flags_nm, curr, axis=0)
        def_left = (flags & 1).astype(bool)
        node_leaf = (flags & 2).astype(bool)
        exch = (flags & 4).astype(bool)
        xv = jnp.take_along_axis(data, fid, axis=1)
        if missing_is_nan:
            miss = jnp.isnan(xv)
        else:
            miss = jnp.abs(xv - jnp.float32(missing)) <= jnp.float32(MISSING_EPS)
        cond = jnp.where(miss, ~def_left, xv >= thresh)
        cond = jnp.where(exch, ~cond, cond)
        curr = jnp.where(node_leaf, curr, 2 * curr + 1 + cond.astype(jnp.int32))
    return jnp.take_along_axis(values_nm, curr, axis=0).sum(axis=1, dtype=jnp.float32)
