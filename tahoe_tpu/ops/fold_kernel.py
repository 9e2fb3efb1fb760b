"""Fold kernel: the VMEM_FOREST / SPLIT_FOREST engine, a Pallas kernel on
the Triton route.

The placement follows the reference's shared-forest and split-forest kernels
(Struct.h:1245-1606): one block per (row tile x tree chunk), a per-(row,
tree) descent, and a separate reduction of the partial margins.

- **Grid** ``(row blocks, tree chunks)``. A program walks its chunk
  ``block_trees`` trees at a time; each step is one [block_trees, block_rows]
  tile of (tree, row) lanes descending ``depth`` levels.
- **Node tables** are the single-compare form of compiler.ge_normalize: a
  node's whole rule (missing route, default direction, exchange bit) is
  ``x'[fid] >= thr`` with ``x' = [x, -x]`` and missing values NaN. In the
  bit-reversed level order of compiler.levelize the children of position
  ``p`` at level ``d`` are ``p`` and ``p + 2^d``, so a step is
  ``p += (x'[fid] >= thr) << d``. Tables are node-major (``[nodes, trees]``,
  level ``d`` at rows ``2^d - 1 ...``): lanes of one tree at one node read
  one address, and neighbouring trees neighbouring addresses.
- **Rows** are feature-major (``[2F, rows]``), so the rows of a tile that
  read one feature read contiguous memory. Node and feature reads are
  data-dependent loads straight from the refs; the chunk's tables stay in
  L1/L2 while its rows stream past.
- **Reduction.** Blocks run in parallel and in no order, so nothing is
  carried between them: each program writes its chunk's partial margins to
  its own row of a ``[chunks, rows]`` slab, and XLA sums the slab.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tahoe_tpu.config import MISSING_EPS, pallas_interpret
from tahoe_tpu.forest.spec import LeveledForest
from tahoe_tpu.ops.transform import apply_output_transform

# Trees per descent step and warps per program: the best of seven block
# configurations probed at the SUSY shape on an H100 (PERF.md; the spread
# across them was 19%).
BLOCK_TREES = 16
NUM_WARPS = 8


class FoldConfig(NamedTuple):
    """Static (hashable) kernel configuration. The distributed layer builds
    one per tree shard and calls :func:`fold_margins` inside shard_map."""

    depth: int
    block_rows: int      # rows per program (power of two)
    block_trees: int     # trees per descent step (power of two)
    chunk_trees: int     # trees per program, a multiple of block_trees
    padded_trees: int    # table width, a multiple of chunk_trees
    interpret: bool = False


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def plan_chunks(num_trees: int, tree_tile: int, block_trees: int):
    """(chunk_trees, padded_trees) for a tree-tile request: chunks are whole
    descent steps (multiples of ``block_trees``), and the table pads the
    tree axis to whole chunks. A tree tile at least the forest's size gives
    one chunk (the VMEM_FOREST placement)."""
    chunk = -(-min(max(tree_tile, 1), max(num_trees, 1)) // block_trees)
    chunk *= block_trees
    padded = -(-max(num_trees, 1) // chunk) * chunk
    return chunk, padded


def build_tables(lev: LeveledForest, padded_trees: int):
    """Node-major kernel tables from the ge form (compiler.ge_normalize):
    (fid int32 [2^D - 1, Tp], thr f32 [2^D - 1, Tp], leaf f32 [2^D, Tp]).
    Padding trees hold NaN thresholds (every compare False, so the descent
    stays at position 0) and zero leaves: they add nothing to a margin."""
    from tahoe_tpu.forest.compiler import ge_normalize

    fid_l, thr_l, leaf = ge_normalize(lev)
    T, D = lev.num_trees, lev.depth
    pad = padded_trees - T
    nodes = max((1 << D) - 1, 1)  # a forest of stumps reads no node
    fid = np.zeros((nodes, padded_trees), np.int32)
    thr = np.full((nodes, padded_trees), np.nan, np.float32)
    for d in range(D):
        fid[(1 << d) - 1 : (1 << (d + 1)) - 1, :T] = fid_l[d].T
        thr[(1 << d) - 1 : (1 << (d + 1)) - 1, :T] = thr_l[d].T
    leaf_t = np.pad(leaf.T.astype(np.float32), ((0, 0), (0, pad)))
    return fid, thr, np.ascontiguousarray(leaf_t)


def canonicalize_rows(x, missing: float, *, col_index=None, block_rows: int):
    """Rows -> the kernel's feature-major ``[x, -x]`` form ``[2F, R_pad]``:
    live columns only (``col_index``), missing values NaN (both compares
    fail on NaN), rows zero-padded to a multiple of ``block_rows``."""
    x = x.astype(jnp.float32)
    if col_index is not None:
        x = x[:, jnp.asarray(col_index)]
    if np.isnan(np.float32(missing)):
        miss = jnp.isnan(x)
    else:
        miss = jnp.abs(x - jnp.float32(missing)) <= jnp.float32(MISSING_EPS)
    x = jnp.where(miss, jnp.float32(np.nan), x)
    x = jnp.concatenate([x, -x], axis=1)
    pad = (-x.shape[0]) % block_rows
    if pad:
        x = jnp.pad(x, ((0, pad), (0, 0)))
    return x.T


def _kernel(x_ref, fid_ref, thr_ref, leaf_ref, out_ref, *, cfg: FoldConfig,
            rows_padded: int):
    br, bt, tp = cfg.block_rows, cfg.block_trees, cfg.padded_trees
    rows = pl.program_id(0) * br + jax.lax.broadcasted_iota(
        jnp.int32, (bt, br), 1)
    lane_tree = jax.lax.broadcasted_iota(jnp.int32, (bt, br), 0)
    first = pl.program_id(1) * cfg.chunk_trees

    def step(j, acc):
        t = first + j * bt + lane_tree
        p = jnp.zeros((bt, br), jnp.int32)
        for d in range(cfg.depth):
            node = ((1 << d) - 1 + p) * tp + t
            v = x_ref[fid_ref[node] * rows_padded + rows]
            p = p + ((v >= thr_ref[node]).astype(jnp.int32) << d)
        return acc + jnp.sum(leaf_ref[p * tp + t], axis=0)

    acc = jax.lax.fori_loop(0, cfg.chunk_trees // bt, step,
                            jnp.zeros((br,), jnp.float32))
    out_ref[...] = acc[None, :]


def fold_partials(cfg: FoldConfig, tables, x_t):
    """The kernel call: partial margins ``[chunks, R_pad]`` for
    feature-major rows ``x_t`` ``[2F, R_pad]`` (see canonicalize_rows)."""
    fid, thr, leaf = tables
    cols, rows_padded = x_t.shape
    if rows_padded % cfg.block_rows or cfg.padded_trees % cfg.chunk_trees:
        raise ValueError("rows and trees must be padded to whole blocks")
    if cols * rows_padded >= 2**31 or leaf.size >= 2**31:
        raise ValueError("kernel indices are int32: split the batch")
    grid = (rows_padded // cfg.block_rows, cfg.padded_trees // cfg.chunk_trees)
    flat = [a.reshape(-1) for a in (x_t, fid, thr, leaf)]
    whole = [pl.BlockSpec(a.shape, lambda r, c: (0,)) for a in flat]
    return pl.pallas_call(
        functools.partial(_kernel, cfg=cfg, rows_padded=rows_padded),
        grid=grid,
        in_specs=whole,
        out_specs=pl.BlockSpec((1, cfg.block_rows), lambda r, c: (c, r)),
        out_shape=jax.ShapeDtypeStruct((grid[1], rows_padded), jnp.float32),
        interpret=cfg.interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        name="tahoe_fold",
    )(*flat)


def fold_margins(cfg: FoldConfig, tables, x_t):
    """Raw margins ``[R_pad]``: the kernel's partial slab summed by XLA."""
    return jnp.sum(fold_partials(cfg, tables, x_t), axis=0)


class FoldKernelEngine:
    """A LeveledForest compiled into node-major tables + a jitted predict.

    ``row_tile`` rows by ``tree_tile`` trees per program (SPLIT_FOREST); a
    tree tile covering the forest runs the whole forest per program
    (VMEM_FOREST). ``interpret`` defaults to config.pallas_interpret()."""

    def __init__(self, leveled: LeveledForest, *, row_tile: int = 128,
                 tree_tile: int = 128, interpret: bool | None = None,
                 col_index=None, compact: bool = True):
        # wide forests (gisette-class) reference a subset of their columns:
        # keep only the live ones (exact, compiler.compact_leveled). Callers
        # that compacted already pass their col_index and compact=False.
        self.col_index = col_index
        if compact:
            from tahoe_tpu.forest.compiler import compact_leveled

            leveled, self.col_index = compact_leveled(leveled)
        self.depth = leveled.depth
        self.num_trees = leveled.num_trees
        self.num_cols = leveled.num_cols
        self.output = leveled.output
        self.global_bias = leveled.global_bias
        self.threshold = leveled.threshold
        self.missing = leveled.missing
        block_trees = min(BLOCK_TREES, _pow2_ceil(tree_tile),
                          _pow2_ceil(self.num_trees))
        chunk, padded = plan_chunks(self.num_trees, tree_tile, block_trees)
        self.cfg = FoldConfig(
            depth=self.depth, block_rows=_pow2_ceil(row_tile),
            block_trees=block_trees, chunk_trees=chunk, padded_trees=padded,
            interpret=pallas_interpret() if interpret is None else interpret,
        )
        self.row_tile = self.cfg.block_rows
        self.tables = tuple(jnp.asarray(a)
                            for a in build_tables(leveled, padded))
        self._predict = jax.jit(self._predict_impl)

    def _canonicalize(self, data):
        return canonicalize_rows(data, self.missing, col_index=self.col_index,
                                 block_rows=self.row_tile)

    def _predict_impl(self, tables, data):
        margins = fold_margins(self.cfg, tables, self._canonicalize(data))
        return apply_output_transform(
            margins[: data.shape[0]], self.num_trees, self.output,
            self.global_bias, self.threshold, jnp,
        )

    def predict(self, data) -> jax.Array:
        return self._predict(self.tables, jnp.asarray(data))
