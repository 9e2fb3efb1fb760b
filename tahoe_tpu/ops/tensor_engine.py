"""Tensorized select-fold engine (ROW_TILED and TENSOR strategies).

The framework's rendition of the reference's smem-resident thread-per-tree
kernel (strategy 3, infer_k_shared_data_adaptive, Struct.h:869-1191) as dense
level algebra in XLA, with no data-dependent node reads:

1. **Level condition evaluation** — for every (row, tree, node-at-level-d)
   compute the branch condition. The per-node feature value is obtained either
   by a static-index ``take`` or by a one-hot matmul ``X @ S_d`` (exact only
   at ``Precision.HIGHEST``: a default-precision f32 product may run in TF32
   on a GPU, which keeps about three decimal digits and would not select
   values exactly).
2. **Select-fold** — fold leaf values bottom-up through the conditions:
   ``w_d = where(c_d, w_{d+1}[second half], w_{d+1}[first half])``.
   Node tables are stored in *bit-reversed order* (compiler.levelize), which
   is what turns the textbook even/odd child interleave into these contiguous
   halving selects. After ``depth`` folds, ``w_0`` is the per-(row, tree) leaf
   value; margins are a tree-axis sum (replacing cub::BlockReduce,
   Struct.h:435-444).

Early leaves were pushed to the bottom and exchange bits folded by the
compiler, so there is no is_leaf masking and no exchange decode in the hot
loop — every step is an unconditional select. Per-node math is otherwise
identical to Struct.h:365-403 / 894-898.
"""
from __future__ import annotations

from typing import Literal

import jax
import jax.numpy as jnp
import numpy as np

from tahoe_tpu.config import MISSING_EPS
from tahoe_tpu.forest.spec import LeveledForest
from tahoe_tpu.ops.transform import apply_output_transform

SelectMode = Literal["take", "onehot"]


def _onehot_matrix(fid_level: np.ndarray, num_cols: int) -> np.ndarray:
    """S_d [F, T*2^d] f32 with S[fid[t,i], t*2^d+i] = 1."""
    flat = fid_level.reshape(-1)
    s = np.zeros((num_cols, flat.size), dtype=np.float32)
    s[flat, np.arange(flat.size)] = 1.0
    return s


class TensorEngine:
    """Device-resident leveled tables + a jitted chunked predict."""

    def __init__(
        self,
        leveled: LeveledForest,
        *,
        select_mode: SelectMode = "onehot",
        row_tile: int = 256,
        interpret: bool = False,
    ):
        self.depth = leveled.depth
        self.num_trees = leveled.num_trees
        self.num_cols = leveled.num_cols
        self.output = leveled.output
        self.global_bias = leveled.global_bias
        self.threshold = leveled.threshold
        self.missing = leveled.missing
        self.select_mode = select_mode
        self.row_tile = row_tile

        self._any_invert = [bool(v.any()) for v in leveled.invert]
        D = leveled.depth
        # tables are a jit argument, not constants baked into the program
        if select_mode == "take":
            sel = [jnp.asarray(f.reshape(-1)) for f in leveled.fid]
        else:
            sel = [
                jnp.asarray(_onehot_matrix(f, leveled.num_cols))
                for f in leveled.fid
            ]
        self.tables = (
            tuple(jnp.asarray(t) for t in leveled.thresh),
            tuple(jnp.asarray(v) for v in leveled.invert),
            tuple(jnp.asarray(v) for v in leveled.def_right),
            jnp.asarray(leveled.leaf_values),
            tuple(sel),
        )
        self._predict = jax.jit(self._predict_impl)

    # ------------------------------------------------------------------
    def _missing(self, x):
        if np.isnan(np.float32(self.missing)):
            return jnp.isnan(x)
        return jnp.abs(x - jnp.float32(self.missing)) <= jnp.float32(MISSING_EPS)

    def _level_inputs_take(self, d, sel, x, miss):
        """(xv, mv) for level d via static-index take."""
        shape = (x.shape[0], self.num_trees, 1 << d)
        xv = jnp.take(x, sel[d], axis=1).reshape(shape)
        mv = jnp.take(miss, sel[d], axis=1).reshape(shape)
        return xv, mv

    def _level_inputs_onehot(self, d, sel, stacked, rt):
        """(xv, mv) for level d via one-hot matmul.

        ``stacked`` is [2*Rt, F]: rows then missing flags, so one matmul feeds
        both. HIGHEST precision keeps the f32 selection bit-exact (TF32 would
        not).
        """
        out = jax.lax.dot_general(
            stacked,
            sel[d],
            (((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )
        shape = (rt, self.num_trees, 1 << d)
        xv = out[:rt].reshape(shape)
        mv = out[rt:] > 0.5
        return xv, mv.reshape(shape)

    # ------------------------------------------------------------------
    def _margins_chunk(self, tables, x):
        """Margins for one row chunk [Rt, F] → [Rt]."""
        thresh, invert, def_right, leaf_values, sel = tables
        rt = x.shape[0]
        miss = self._missing(x)
        if self.select_mode == "onehot":
            xc = jnp.where(miss, jnp.float32(0), x)
            stacked = jnp.concatenate([xc, miss.astype(jnp.float32)], axis=0)

        w = None
        for d in range(self.depth - 1, -1, -1):
            if self.select_mode == "take":
                xv, mv = self._level_inputs_take(d, sel, x, miss)
            else:
                xv, mv = self._level_inputs_onehot(d, sel, stacked, rt)
            cmp = xv >= thresh[d][None]
            if self._any_invert[d]:
                cmp = cmp ^ invert[d][None]
            cond = jnp.where(mv, def_right[d][None], cmp)
            half = 1 << d
            if w is None:
                lv = leaf_values[None]
                w = jnp.where(cond, lv[:, :, half:], lv[:, :, :half])
            else:
                w = jnp.where(cond, w[..., half:], w[..., :half])

        if w is None:  # depth 0: forest of stumps
            return jnp.broadcast_to(leaf_values[:, 0].sum(), (rt,))
        return w[..., 0].sum(axis=1, dtype=jnp.float32)

    def _predict_impl(self, tables, data):
        data = data.astype(jnp.float32)
        rows = data.shape[0]
        tile = self.row_tile
        pad = (-rows) % tile
        if pad:
            data = jnp.concatenate(
                [data, jnp.zeros((pad, data.shape[1]), jnp.float32)], axis=0
            )
        chunks = data.reshape(-1, tile, data.shape[1])
        margins = jax.lax.map(
            lambda c: self._margins_chunk(tables, c), chunks
        ).reshape(-1)[:rows]
        return apply_output_transform(
            margins, self.num_trees, self.output, self.global_bias,
            self.threshold, jnp,
        )

        return jax.lax.fori_loop(
            0, k, body, jnp.zeros(data.shape[0], jnp.float32)
        )

    # ------------------------------------------------------------------
    def margins(self, data) -> jax.Array:
        """Raw margins (pre-transform), mainly for tests."""
        data = jnp.asarray(data, dtype=jnp.float32)
        return self._margins_chunk(self.tables, data)

    def predict(self, data) -> jax.Array:
        return self._predict(self.tables, jnp.asarray(data))
