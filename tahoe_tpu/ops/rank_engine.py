"""RANK_MXU: int8 rank traversal in plain XLA.

Every routing rule of a rank-quantized forest is one int8 matrix column
(compiler.rank_normalize): for the int8 plane vector ``p`` of a row
(quantize.encode_rank_planes_device), ``p . R_d[:, n] >= 0`` is exactly the
branch condition of node ``n`` at level ``d`` — missing route, default
direction, exchange bit and compare included. A level is therefore one
``dot_general(int8, int8 -> int32)``, which XLA hands to the int8 tensor
cores, followed by ``>= 0`` and the select-fold of tensor_engine.

The condition block of a level is [rows, trees * 2^d]; a SUSY-class forest
(127,500 node columns) cannot hold it for 65,536 rows at once. Rows and trees
are therefore walked in chunks (``lax.map`` over row chunks, ``lax.scan``
over tree chunks) sized so that the bottom level's block stays under
CHUNK_ELEMS elements.

All arithmetic is exact integer arithmetic; the leaf sum is f32 (the
reference's 1e-3 bound covers its association order).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from tahoe_tpu.forest.compiler import (
    RANK_LANE_C1,
    RANK_MAX_COLS,
    compact_features,
    levelize,
    rank_groups,
    rank_normalize,
    reachable_depths,
    truncate_depth,
)
from tahoe_tpu.forest.quantize import (
    band_split,
    encode_rank_planes_device,
    quantize,
    quantized_spec_for_engines,
    transform_rows_device,
)
from tahoe_tpu.forest.spec import ForestSpec
from tahoe_tpu.ops.transform import apply_output_transform

# Upper size of one condition block (int32 elements): 256 MiB.
CHUNK_ELEMS = 1 << 26


class RankConfig(NamedTuple):
    depth: int
    groups: int
    tree_chunk: int
    row_chunk: int


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


def plan_chunks(num_trees: int, depth: int, rows: int,
                tree_chunk: Optional[int] = None):
    """(tree_chunk, row_chunk) with ``row_chunk * tree_chunk * 2^(depth-1)
    <= CHUNK_ELEMS``: up to 128 trees per chunk while a chunk still takes at
    least 256 rows, and as many rows as the budget then allows."""
    per_tree = 1 << max(depth - 1, 0)
    if tree_chunk is None:
        tree_chunk = min(128, _pow2_floor(max(num_trees, 1) * 2 - 1),
                         _pow2_floor(max(CHUNK_ELEMS // (256 * per_tree), 1)))
    row_chunk = _pow2_floor(max(CHUNK_ELEMS // (tree_chunk * per_tree), 1))
    row_chunk = min(row_chunk, 1 << max(rows - 1, 0).bit_length())
    return int(tree_chunk), int(row_chunk)


def rank_margins(cfg: RankConfig, tables, planes):
    """Raw margins for int8 planes ``[R, 128G]``, ``R`` a multiple of
    ``cfg.row_chunk``. Pure function of (static cfg, tables, planes): usable
    under jit and shard_map."""
    mats, leaf = tables  # mats[d]: [C, 128G, Tc*2^d] int8; leaf [C, Tc, 2^D]
    D, rc, tc = cfg.depth, cfg.row_chunk, cfg.tree_chunk

    def tree_chunk(acc, tab):
        p, (ms, lf) = acc[1], tab
        w = lf
        for d in range(D - 1, -1, -1):
            c = jax.lax.dot_general(p, ms[d], (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.int32)
            c = (c >= 0).reshape(rc, tc, 1 << d)
            w = jnp.where(c, w[..., 1 << d:], w[..., : 1 << d])
        part = (jnp.sum(w[..., 0], axis=-1) if D else
                jnp.broadcast_to(jnp.sum(lf), (rc,)))
        return (acc[0] + part, p), None

    def row_chunk(p):
        (m, _), _ = jax.lax.scan(
            tree_chunk, (jnp.zeros((rc,), jnp.float32), p), (mats, leaf))
        return m

    rows = planes.shape[0]
    chunks = planes.reshape(rows // rc, rc, planes.shape[1])
    return jax.lax.map(row_chunk, chunks).reshape(rows)


class RankEngine:
    """Rank-quantize a forest, build the per-level int8 matrices, and predict
    raw f32 rows: transform + plane encoding + traversal in one jit."""

    def __init__(self, forest: ForestSpec, *, band: Optional[int] = None,
                 tree_chunk: Optional[int] = None, prequantized=None):
        if prequantized is not None:
            # (RankQuantizedForest, column gather or None) from a caller that
            # quantized a larger forest once and hands over a tree subset
            # (depth-bucketed execution shares one transform)
            self.q, self.col_gather = prequantized
        else:
            # drop unreachable filler levels, keep live features, then split
            # features with more thresholds than the plane encoding holds
            # into banded virtual features (quantize.band_split)
            forest = truncate_depth(
                forest, int(reachable_depths(forest).max(initial=0)))
            forest, col_index = compact_features(forest)
            if forest.num_cols > RANK_MAX_COLS:
                raise NotImplementedError(
                    f"rank form supports <= {RANK_MAX_COLS} live features; "
                    f"got {forest.num_cols}")
            self.q, vf_base = band_split(quantize(forest), band)
            if col_index is None:
                self.col_gather = vf_base
            elif vf_base is None:
                self.col_gather = col_index
            else:
                self.col_gather = col_index[vf_base]
        if self.q.spec.num_cols > RANK_MAX_COLS:
            raise NotImplementedError(
                f"banded forest needs {self.q.spec.num_cols} virtual "
                f"features > {RANK_MAX_COLS}")
        lev = levelize(quantized_spec_for_engines(self.q))
        self.depth = lev.depth
        self.num_trees = lev.num_trees
        self.num_cols = lev.num_cols
        self.output = lev.output
        self.global_bias = lev.global_bias
        self.threshold = lev.threshold
        self.groups = rank_groups(lev.num_cols)
        self.tree_chunk, _ = plan_chunks(lev.num_trees, lev.depth, 1,
                                         tree_chunk=tree_chunk)
        self.tables = self._build_tables(lev)
        self._predict = jax.jit(self._predict_impl)

    @property
    def num_chunks(self) -> int:
        return self.tables[1].shape[0]

    def _build_tables(self, lev):
        mats, leaf = rank_normalize(lev)
        tc = self.tree_chunk
        T = lev.num_trees
        tp = -(-T // tc) * tc
        C = tp // tc
        out = []
        for m in mats:  # [128G, T, n]
            L, _, n = m.shape
            if tp != T:
                # padding trees: diff = -1 at every node (cond False), leaf 0
                pad = np.zeros((L, tp - T, n), np.int8)
                pad[RANK_LANE_C1] = -1
                m = np.concatenate([m, pad], axis=1)
            m = m.reshape(L, C, tc * n).transpose(1, 0, 2)
            out.append(jnp.asarray(np.ascontiguousarray(m)))
        leaf = np.pad(leaf, ((0, tp - T), (0, 0)))
        return tuple(out), jnp.asarray(leaf.reshape(C, tc, -1))

    def config(self, rows: int) -> RankConfig:
        _, rc = plan_chunks(self.num_trees, self.depth, rows,
                            tree_chunk=self.tree_chunk)
        return RankConfig(self.depth, self.groups, self.tree_chunk, rc)

    def planes(self, data):
        """f32 rows -> int8 plane vectors [R, 128G] (rank transform on the
        device, quantize.transform_rows_device)."""
        x = jnp.asarray(data, jnp.float32)
        if self.col_gather is not None:
            x = x[:, jnp.asarray(self.col_gather)]
        return encode_rank_planes_device(transform_rows_device(self.q, x))

    def margins_from_planes(self, tables, planes):
        rows = planes.shape[0]
        cfg = self.config(rows)
        pad = (-rows) % cfg.row_chunk
        if pad:
            planes = jnp.pad(planes, ((0, pad), (0, 0)))
        return rank_margins(cfg, tables, planes)[:rows]

    def _predict_impl(self, tables, data):
        margins = self.margins_from_planes(tables, self.planes(data))
        return apply_output_transform(
            margins, self.num_trees, self.output, self.global_bias,
            self.threshold, jnp,
        )

    def predict(self, data) -> jax.Array:
        return self._predict(self.tables, jnp.asarray(data))
