"""Pallas fold kernel (Triton route) vs the oracle, under the Pallas
interpreter on the CPU; plus the wrapper's padding, chunk plan and
partial-margin sum.

Tolerance: the kernel compares f32 values and selects leaves exactly, so
only the association of the tree sum differs from the oracle — 1e-5 at
these sizes (the reference's contract is 1e-3, cuda_base.h:103).
"""
import numpy as np
import pytest

from tahoe_tpu.config import Output
from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.fold_kernel import (
    FoldKernelEngine,
    build_tables,
    canonicalize_rows,
    fold_partials,
    plan_chunks,
)


def _engine(forest, **kw):
    lev = compiler.levelize(compiler.hot_child_swap(forest))
    kw.setdefault("interpret", True)
    return FoldKernelEngine(lev, **kw)


@pytest.mark.parametrize("depth,trees,cols,leaf_prob", [
    (0, 3, 2, 0.0),
    (1, 5, 3, 0.0),
    (4, 17, 9, 0.2),
    (5, 70, 30, 0.15),   # trees > tree_tile: several chunks, slab sum
])
def test_matches_oracle(depth, trees, cols, leaf_prob):
    forest = synthetic.generate_forest(trees, depth, cols, leaf_prob=leaf_prob,
                                       seed=depth + 70)
    data = synthetic.generate_data(37, cols, missing_prob=0.1, seed=depth + 170)
    eng = _engine(forest, row_tile=16, tree_tile=32)
    got = np.asarray(eng.predict(data))
    want = oracle.predict(forest, data)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_finite_missing_sentinel():
    forest = synthetic.generate_forest(11, 4, 5, missing=-999.0, leaf_prob=0.1,
                                       seed=81)
    data = synthetic.generate_data(45, 5, missing=-999.0, missing_prob=0.25,
                                   seed=82)
    eng = _engine(forest, row_tile=8, tree_tile=16)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(forest, data), atol=1e-5
    )


def test_no_hot_swap_variant():
    """Kernel must also run forests without the swap pass (invert all-zero)."""
    forest = synthetic.generate_forest(9, 4, 7, leaf_prob=0.1, seed=83)
    data = synthetic.generate_data(29, 7, missing_prob=0.1, seed=84)
    lev = compiler.levelize(forest)
    eng = FoldKernelEngine(lev, row_tile=8, tree_tile=16, interpret=True)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(forest, data), atol=1e-5
    )


def test_output_transform():
    forest = synthetic.generate_forest(
        9, 3, 6, output=int(Output.AVG | Output.SIGMOID), global_bias=0.5, seed=85
    )
    data = synthetic.generate_data(19, 6, seed=86)
    eng = _engine(forest, row_tile=8, tree_tile=16)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(forest, data), atol=1e-6
    )


def test_threshold_ties_and_infinities():
    """Rows that hit thresholds exactly, and +-inf, route like the oracle."""
    forest = synthetic.generate_forest(9, 4, 6, seed=87)
    data = synthetic.generate_data(40, 6, missing_prob=0.1, seed=88)
    data[0, :] = forest.values[0, :6]
    data[1, 0], data[2, 1] = np.inf, -np.inf
    eng = _engine(forest, row_tile=8, tree_tile=8)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(forest, data), atol=1e-5
    )


def test_wide_forest_has_no_feature_cap():
    """Feature reads are loads from the row ref, so a forest with > 512 live
    features runs too."""
    forest = synthetic.generate_forest(300, 4, 2000, seed=88)
    assert len(np.unique(forest.fids[~forest.is_leaf])) > 512
    data = synthetic.generate_data(24, 2000, missing_prob=0.05, seed=89)
    eng = _engine(forest, row_tile=8, tree_tile=128)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(forest, data), atol=1e-4
    )


def test_depth_nine():
    """covtype-class depth; exercises multi-chunk levels beyond 2^8."""
    forest = synthetic.generate_forest(12, 9, 16, leaf_prob=0.1, seed=99)
    data = synthetic.generate_data(21, 16, missing_prob=0.1, seed=199)
    eng = _engine(forest, row_tile=8, tree_tile=8)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(forest, data), atol=1e-5
    )


@pytest.mark.parametrize("depth", [10, 12, 13])
def test_deep_forest(depth):
    """Deep forests: the descent costs depth steps per (row, tree), so the
    kernel needs no subtree blocking."""
    forest = synthetic.generate_forest(6, depth, 12, leaf_prob=0.1, seed=91)
    data = synthetic.generate_data(33, 12, missing_prob=0.1, seed=92)
    eng = _engine(forest, row_tile=16, tree_tile=8)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(forest, data), atol=1e-5
    )


def test_deep_forest_facade_dispatch():
    """Depth-12 forests run the kernel through the facade."""
    from tahoe_tpu.config import Strategy
    from tahoe_tpu.engine.forest import Forest

    forest = synthetic.generate_forest(12, 12, 10, leaf_prob=0.05, seed=94)
    f = Forest(forest)
    assert f.feasible(Strategy.SPLIT_FOREST) is None
    data = synthetic.generate_data(24, 10, missing_prob=0.05, seed=95)
    got = np.asarray(f.predict(data, Strategy.SPLIT_FOREST))
    np.testing.assert_allclose(got, f.predict_oracle(data), atol=1e-5)


# --- the wrapper: chunk plan, padding, slab -------------------------------

@pytest.mark.parametrize("trees,tile,block,want", [
    (500, 128, 16, (128, 512)),   # SPLIT_FOREST: 4 chunks, 12 padding trees
    (500, 500, 16, (512, 512)),   # VMEM_FOREST: one chunk holds the forest
    (48, 16, 16, (16, 48)),       # exact fit, no padding
    (5, 128, 8, (8, 8)),          # tiny forest: one step of 8 lanes
    (70, 32, 32, (32, 96)),
])
def test_plan_chunks(trees, tile, block, want):
    chunk, padded = plan_chunks(trees, tile, block)
    assert (chunk, padded) == want
    assert chunk % block == 0 and padded % chunk == 0 and padded >= trees


def test_block_trees_follow_the_tree_tile():
    forest = synthetic.generate_forest(64, 3, 5, seed=3)
    eng = _engine(forest, tree_tile=8)
    assert eng.cfg.block_trees == 8 and eng.cfg.chunk_trees == 8
    assert eng.cfg.padded_trees == 64


def test_padding_trees_add_nothing():
    """Padding trees (NaN thresholds, zero leaves) stay at position 0 and
    contribute 0 to every margin."""
    forest = synthetic.generate_forest(5, 3, 4, seed=5)
    lev = compiler.levelize(forest)
    fid, thr, leaf = build_tables(lev, 16)
    assert fid.shape == (7, 16) and leaf.shape == (8, 16)
    assert np.isnan(thr[:, 5:]).all() and not leaf[:, 5:].any()


def test_rows_padded_to_block_and_feature_major():
    import jax.numpy as jnp

    x = np.array([[1.0, -999.0], [np.nan, 2.0], [3.0, 4.0]], np.float32)
    x_t = np.asarray(canonicalize_rows(jnp.asarray(x), -999.0, block_rows=4))
    assert x_t.shape == (4, 4)  # [x, -x] features by rows padded 3 -> 4
    np.testing.assert_array_equal(x_t[0, [0, 2]], [1.0, 3.0])
    assert np.isnan(x_t[1, 0]) and np.isnan(x_t[3, 0])  # sentinel -> NaN
    np.testing.assert_array_equal(x_t[2, [0, 2]], [-1.0, -3.0])
    assert not x_t[:, 3].any()  # padding row


def test_partial_slab_sums_to_margins():
    """Each tree chunk writes its own slab row; the rows sum to the margin."""
    import jax.numpy as jnp

    forest = synthetic.generate_forest(40, 4, 6, leaf_prob=0.1, seed=7)
    data = synthetic.generate_data(20, 6, missing_prob=0.1, seed=8)
    eng = _engine(forest, row_tile=8, tree_tile=8)
    x_t = eng._canonicalize(jnp.asarray(data))
    slab = np.asarray(fold_partials(eng.cfg, eng.tables, x_t))
    assert slab.shape == (5, 24)  # 5 chunks of 8 trees, rows padded to 24
    want = oracle.predict_margins(forest, data)
    np.testing.assert_allclose(slab.sum(axis=0)[:20], want, atol=1e-5)
    # chunk c's row is the margin of its own trees
    from tahoe_tpu.ops.bucketed import subset_trees

    lev_order = compiler.hot_child_swap(forest)
    first = oracle.predict_margins(subset_trees(lev_order, np.arange(8)), data)
    np.testing.assert_allclose(slab[0, :20], first, atol=1e-5)
