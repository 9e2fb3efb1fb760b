"""Sharded inference: batch-sharded, tree-sharded, and 2-D composed.

Built on shard_map over a ``(data, model)`` Mesh (mesh.py). Rows shard over
``data`` with zero communication; trees shard over ``model`` and per-shard
margins combine with a single f32 ``psum`` after traversal — one scalar per
row, which XLA hands to NCCL over NVLink between the cards of a host. The
output transform runs after the psum, on whole margins.

Each device runs the single-device engine's pure margins function on its
(row shard x tree shard): the fold kernel, the int8 rank path, or the CSR
descent. Numerics match the single-device engine up to the association of
the tree sum (covered by the oracle tolerance, cuda_base.h:103).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tahoe_tpu.forest.spec import ForestSpec, LeveledForest
from tahoe_tpu.ops.transform import apply_output_transform


def _combine(m, n_model: int):
    # cross-device margin combine: the distributed DeviceSegmentedReduce
    # (Struct.h:655-659) — one f32 psum per row
    return jax.lax.psum(m, "model") if n_model > 1 else m


class _Sharded:
    """Shared plumbing: a mesh, a tree-sharded table pytree, rows sharded
    over ``data``, and the output transform after the psum."""

    def _init_mesh(self, mesh: Mesh):
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.n_model = mesh.shape["model"]

    def _place(self, tables, specs):
        """Put each table on the mesh once, as the shard_map will read it,
        so that no call moves tables between devices."""
        self.table_specs = specs
        self.tables = jax.tree.map(
            lambda t, s: jax.device_put(t, NamedSharding(self.mesh, s)),
            tables, specs)

    def _shard_call(self, local_fn, tables, rows_arg, rows_spec, rows: int):
        shard = jax.shard_map(
            local_fn, mesh=self.mesh, in_specs=(self.table_specs, rows_spec),
            out_specs=P("data"),
            # pallas_call's output carries no varying-mesh-axes annotation
            check_vma=False,
        )
        margins = shard(tables, rows_arg)[:rows]
        return apply_output_transform(
            margins, self.num_trees, self.output, self.global_bias,
            self.threshold, jnp,
        )

    def predict(self, data) -> jax.Array:
        return self._predict(self.tables, jnp.asarray(data, jnp.float32))


def _pad_rows(x, block: int, axis: int = 0):
    pad = (-x.shape[axis]) % block
    if not pad:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


class ShardedForestEngine(_Sharded):
    """Fold-kernel inference over a device mesh.

    ``mesh`` must have axes ("data", "model"); either may be size 1. The
    tree axis of the node-major tables splits into ``model`` equal shards of
    whole tree chunks; rows are sharded over "data" per call.
    """

    def __init__(self, leveled: LeveledForest, mesh: Mesh, *,
                 row_tile: int = 128, tree_tile: int = 128):
        from tahoe_tpu.ops.fold_kernel import FoldKernelEngine

        self._init_mesh(mesh)
        self._base = FoldKernelEngine(leveled, row_tile=row_tile,
                                      tree_tile=tree_tile)
        base = self._base
        chunks = base.cfg.padded_trees // base.cfg.chunk_trees
        if chunks % self.n_model:
            raise ValueError(
                f"{chunks} tree chunks not divisible by model axis "
                f"{self.n_model}; choose tree_tile so chunks divide evenly")
        self.cfg = base.cfg._replace(
            padded_trees=base.cfg.padded_trees // self.n_model)
        self.num_trees = base.num_trees
        self.output = base.output
        self.global_bias = base.global_bias
        self.threshold = base.threshold
        self.row_tile = base.row_tile
        # node-major [nodes, Tp] tables: trees on axis 1
        self._place(base.tables, tuple(P(None, "model") for _ in base.tables))
        self._predict = jax.jit(self._predict_impl)

    def _predict_impl(self, tables, data):
        from tahoe_tpu.ops.fold_kernel import fold_margins

        x_t = _pad_rows(self._base._canonicalize(data),
                        self.row_tile * self.n_data, axis=1)
        cfg, n_model = self.cfg, self.n_model

        def local_fn(tables_local, x_local):
            return _combine(fold_margins(cfg, tables_local, x_local), n_model)

        return self._shard_call(local_fn, tables, x_t, P(None, "data"),
                                data.shape[0])


class ShardedRankEngine(_Sharded):
    """Tree-sharded int8 rank inference over a device mesh: the per-level
    matrices shard on their tree-chunk axis across ``model``; rows shard
    across ``data``. The rank transform (tables replicated) runs once on the
    global batch; per-shard margins combine with the same single f32
    ``psum`` as the fold engine."""

    def __init__(self, forest: ForestSpec, mesh: Mesh, *,
                 tree_tile: int | None = None):
        from tahoe_tpu.ops.rank_engine import RankEngine

        self._init_mesh(mesh)
        self._base = RankEngine(forest, tree_chunk=tree_tile)
        base = self._base
        if base.num_chunks % self.n_model:
            raise ValueError(
                f"{base.num_chunks} tree chunks not divisible by model axis "
                f"{self.n_model}; choose tree_tile so chunks divide evenly")
        self.num_trees = base.num_trees
        self.output = base.output
        self.global_bias = base.global_bias
        self.threshold = base.threshold
        self.groups = base.groups
        self._place(base.tables, jax.tree.map(
            lambda t: P("model", *(None,) * (t.ndim - 1)), base.tables))
        self._predict = jax.jit(self._predict_impl)

    def _predict_impl(self, tables, data):
        from tahoe_tpu.ops.rank_engine import rank_margins

        rows = data.shape[0]
        cfg = self._base.config(-(-rows // self.n_data))
        planes = _pad_rows(self._base.planes(data),
                           cfg.row_chunk * self.n_data)
        n_model = self.n_model

        def local_fn(tables_local, planes_local):
            return _combine(rank_margins(cfg, tables_local, planes_local),
                            n_model)

        return self._shard_call(local_fn, tables, planes, P("data", None),
                                rows)


class ShardedSparseEngine(_Sharded):
    """Tree-sharded CSR descent: the trees split into ``model`` equal
    groups, each with its own pruned node pool (pools padded to one size with
    never-visited leaf slots); rows shard across ``data``; per-shard margins
    combine with the same f32 ``psum``. Giant trained forests are where tree
    sharding pays: each card holds only its shard's pool."""

    def __init__(self, forest: ForestSpec, mesh: Mesh):
        from tahoe_tpu.forest.sparse import from_dense, sparse_tables

        from tahoe_tpu.ops.bucketed import subset_trees

        self._init_mesh(mesh)
        T = forest.num_trees
        if T % self.n_model:
            raise ValueError(f"{T} trees not divisible by model axis "
                             f"{self.n_model}")
        per = T // self.n_model
        pools = [from_dense(subset_trees(forest, np.arange(i * per,
                                                           (i + 1) * per)))
                 for i in range(self.n_model)]
        size = max(p.num_nodes for p in pools)
        shards = []
        for p in pools:
            tabs = [np.asarray(t) for t in sparse_tables(p)]
            pad = size - p.num_nodes
            # padding slots: leaf flag set (bit1), value 0, never reached
            fills = (0.0, 0, 2, -1)
            tabs[:4] = [np.concatenate([t, np.full(pad, f, t.dtype)])
                        for t, f in zip(tabs[:4], fills)]
            shards.append(tabs)
        stacked = tuple(np.stack(ts) for ts in zip(*shards))  # [n_model, ..]
        self._place(stacked, tuple(P("model", None) for _ in stacked))
        self.max_depth = max(p.max_depth for p in pools)
        self.missing = forest.missing
        self.num_trees = T
        self.output = forest.output
        self.global_bias = forest.global_bias
        self.threshold = forest.threshold
        self._predict = jax.jit(self._predict_impl)

    def _predict_impl(self, tables, data):
        from tahoe_tpu.forest.sparse import sparse_margins

        x = _pad_rows(data, self.n_data)
        depth, missing, n_model = self.max_depth, self.missing, self.n_model

        def local_fn(tables_local, x_local):
            local = tuple(t[0] for t in tables_local)  # drop the shard axis
            m = sparse_margins(local, x_local, max_depth=depth,
                               missing=missing)
            return _combine(m, n_model)

        return self._shard_call(local_fn, tables, x, P("data", None),
                                data.shape[0])


def batch_sharded_put(data, mesh: Mesh):
    """Place rows across the data axis ahead of time (multi-host input path)."""
    return jax.device_put(
        jnp.asarray(data, jnp.float32), NamedSharding(mesh, P("data", None))
    )
