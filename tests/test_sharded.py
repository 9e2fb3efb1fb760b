"""Distributed inference on the virtual 8-device CPU mesh."""
import numpy as np
import pytest

from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.ops import oracle
from tahoe_tpu.parallel.mesh import make_mesh
from tahoe_tpu.parallel.sharded import ShardedForestEngine, batch_sharded_put


@pytest.fixture(scope="module")
def setup():
    forest = synthetic.generate_forest(48, 4, 12, leaf_prob=0.1, seed=101)
    data = synthetic.generate_data(96, 12, missing_prob=0.1, seed=102)
    lev = compiler.levelize(forest)
    want = oracle.predict(forest, data)
    return forest, lev, data, want


def test_batch_sharded(setup):
    _, lev, data, want = setup
    mesh = make_mesh(data=4, model=1)
    eng = ShardedForestEngine(lev, mesh, row_tile=8, tree_tile=16)
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tree_sharded_psum(setup):
    _, lev, data, want = setup
    mesh = make_mesh(data=1, model=3)  # 48 trees / tile 16 = 3 tiles → 3 shards
    eng = ShardedForestEngine(lev, mesh, row_tile=8, tree_tile=16)
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_2d_mesh(setup):
    _, lev, data, want = setup
    mesh = make_mesh(data=2, model=3)
    eng = ShardedForestEngine(lev, mesh, row_tile=8, tree_tile=16)
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_presharded_input(setup):
    _, lev, data, want = setup
    mesh = make_mesh(data=4, model=2)
    eng = ShardedForestEngine(lev, mesh, row_tile=8, tree_tile=8)
    data_sharded = batch_sharded_put(data, mesh)
    got = np.asarray(eng.predict(data_sharded))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_uneven_shard_rejected(setup):
    _, lev, _, _ = setup
    mesh = make_mesh(data=1, model=5)
    with pytest.raises(ValueError, match="divisible|divide"):
        ShardedForestEngine(lev, mesh, row_tile=8, tree_tile=16)


def test_tree_sharded_deep(setup):
    """Deep forest sharded over the model axis: each shard walks its own
    tree chunks of the node-major tables."""
    forest = synthetic.generate_forest(16, 9, 10, leaf_prob=0.1, seed=103)
    data = synthetic.generate_data(32, 10, missing_prob=0.1, seed=104)
    lev = compiler.levelize(forest)
    want = oracle.predict(forest, data)
    mesh = make_mesh(data=1, model=2)
    eng = ShardedForestEngine(lev, mesh, row_tile=8, tree_tile=8)
    assert eng.cfg.padded_trees == 8
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rank_tree_sharded_psum(setup):
    """int8 rank engine sharded on the tree-chunk axis."""
    from tahoe_tpu.parallel.sharded import ShardedRankEngine

    forest, _, data, want = setup
    mesh = make_mesh(data=1, model=3)  # 48 trees / tile 16 = 3 tiles
    eng = ShardedRankEngine(forest, mesh, tree_tile=16)
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rank_2d_mesh(setup):
    from tahoe_tpu.parallel.sharded import ShardedRankEngine

    forest, _, data, want = setup
    mesh = make_mesh(data=2, model=3)
    eng = ShardedRankEngine(forest, mesh, tree_tile=16)
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rank_sharded_deep(setup, monkeypatch):
    """Deep rank forest under shard_map, several row chunks per shard."""
    from tahoe_tpu.ops import rank_engine
    from tahoe_tpu.parallel.sharded import ShardedRankEngine

    monkeypatch.setattr(rank_engine, "CHUNK_ELEMS", 1 << 12)
    forest = synthetic.generate_forest(32, 9, 10, leaf_prob=0.1, seed=107)
    data = synthetic.generate_data(32, 10, missing_prob=0.1, seed=108)
    want = oracle.predict(forest, data)
    mesh = make_mesh(data=2, model=2)
    eng = ShardedRankEngine(forest, mesh, tree_tile=16)
    assert eng._base.config(16).row_chunk < 16
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_rank_uneven_shard_rejected(setup):
    from tahoe_tpu.parallel.sharded import ShardedRankEngine

    forest, _, _, _ = setup
    mesh = make_mesh(data=1, model=5)
    with pytest.raises(ValueError, match="divisible|divide"):
        ShardedRankEngine(forest, mesh, tree_tile=16)


def test_mesh_shape_invariance(setup):
    """Predictions must be identical (up to f32 psum reordering) across every
    mesh factorization of the same device count — the property that makes the
    scaling harness's efficiency numbers comparable."""
    forest = synthetic.generate_forest(64, 4, 12, leaf_prob=0.1, seed=105)
    data = synthetic.generate_data(96, 12, missing_prob=0.1, seed=106)
    lev = compiler.levelize(forest)
    want = oracle.predict(forest, data)
    outs = []
    for nd, nm in [(8, 1), (4, 2), (2, 4), (1, 8)]:
        mesh = make_mesh(data=nd, model=nm)
        eng = ShardedForestEngine(lev, mesh, row_tile=8, tree_tile=8)
        outs.append(np.asarray(eng.predict(data)))
        np.testing.assert_allclose(outs[-1], want, atol=1e-5)
    for o in outs[1:]:
        np.testing.assert_allclose(o, outs[0], atol=1e-5)


def test_sparse_tree_sharded_psum():
    """CSR descent sharded on the tree axis: one pruned pool per shard,
    margins psum'd; rows across data."""
    from tahoe_tpu.parallel.sharded import ShardedSparseEngine

    forest = synthetic.generate_mixed_depth_forest(
        256, 6, 10, min_depth=2, leaf_prob=0.25, seed=111
    )
    data = synthetic.generate_data(48, 10, missing_prob=0.1, seed=112)
    want = oracle.predict(forest, data)
    mesh = make_mesh(data=2, model=2)
    eng = ShardedSparseEngine(forest, mesh)
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_sparse_uneven_shard_rejected():
    from tahoe_tpu.parallel.sharded import ShardedSparseEngine

    forest = synthetic.generate_mixed_depth_forest(
        129, 5, 8, min_depth=2, leaf_prob=0.25, seed=113
    )
    mesh = make_mesh(data=1, model=2)  # 129 trees, 2 shards
    with pytest.raises(ValueError, match="divisible|divide"):
        ShardedSparseEngine(forest, mesh)


def test_tables_placed_on_the_mesh_once(setup):
    """Tables live on the mesh as the shard_map reads them: trees split over
    ``model``, replicated over ``data``."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    _, lev, data, want = setup
    mesh = make_mesh(data=2, model=3)
    eng = ShardedForestEngine(lev, mesh, row_tile=8, tree_tile=16)
    for t in eng.tables:
        assert t.sharding == NamedSharding(mesh, P(None, "model"))
    np.testing.assert_allclose(np.asarray(eng.predict(data)), want, atol=1e-5)
