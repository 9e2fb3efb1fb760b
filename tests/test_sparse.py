"""Sparse (CSR) forest: converter pruning, oracle parity, device engine."""
import numpy as np
import pytest

from tahoe_tpu.forest import compiler, sparse, synthetic
from tahoe_tpu.ops import oracle


@pytest.fixture(scope="module")
def dense():
    return synthetic.generate_forest(15, 6, 10, leaf_prob=0.35, seed=131)


@pytest.fixture(scope="module")
def data():
    return synthetic.generate_data(70, 10, missing_prob=0.12, seed=132)


def test_pruning(dense):
    sf = sparse.from_dense(dense)
    assert sf.num_nodes < dense.num_nodes, "early leaves must prune subtrees"
    assert sf.num_trees == dense.num_trees


def test_numpy_parity(dense, data):
    sf = sparse.from_dense(dense)
    np.testing.assert_allclose(
        sparse.predict_np(sf, data), oracle.predict(dense, data), atol=1e-6
    )


def test_device_engine_parity(dense, data):
    sf = sparse.from_dense(dense)
    eng = sparse.SparseGatherEngine(sf)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(dense, data), atol=1e-5
    )


def test_exchange_bits_preserved(data):
    dense = synthetic.generate_forest(8, 5, 10, leaf_prob=0.2, seed=133)
    swapped = compiler.hot_child_swap(dense)
    sf = sparse.from_dense(swapped)
    np.testing.assert_allclose(
        sparse.predict_np(sf, data), oracle.predict(dense, data), atol=1e-6
    )


def test_deep_forest_path():
    """Depth-16 dense storage would be 65k slots/tree; sparse stays small with
    aggressive early leaves."""
    deep = synthetic.generate_forest(3, 14, 6, leaf_prob=0.6, seed=134)
    sf = sparse.from_dense(deep)
    assert sf.num_nodes < 3000
    data = synthetic.generate_data(20, 6, seed=135)
    np.testing.assert_allclose(
        sparse.predict_np(sf, data), oracle.predict(deep, data), atol=1e-6
    )


def test_sparse_strategy_via_facade():
    """SPARSE is a first-class Strategy: enumerable,
    feasibility-checked, engine-built through the facade."""
    from tahoe_tpu.config import Strategy
    from tahoe_tpu.engine.forest import Forest

    forest = synthetic.generate_forest(24, 6, 10, leaf_prob=0.2, seed=51)
    data = synthetic.generate_data(64, 10, missing_prob=0.1, seed=52)
    f = Forest(forest)
    assert f.feasible(Strategy.SPARSE) is None
    got = np.asarray(f.predict(data, strategy=Strategy.SPARSE))
    np.testing.assert_allclose(got, oracle.predict(forest, data), atol=1e-5)


def test_descent_preferred_for_very_deep():
    """Depth-16 trained shape: the leveled engines stay depth-infeasible, and
    the strategies whose work is 2^depth per tree (rank, one-hot, take) must
    never win against the depth-linear descents (fold kernel, CSR, gather)."""
    from tahoe_tpu.config import Strategy
    from tahoe_tpu.engine import feasibility
    from tahoe_tpu.perf_model import model
    from tahoe_tpu.perf_model.calibrate import Calibration

    forest = synthetic.generate_mixed_depth_forest(
        16, 16, 10, min_depth=16, leaf_prob=0.3, seed=53
    )
    assert feasibility.check(Strategy.SPARSE, forest) is None
    for s in (Strategy.TENSOR, Strategy.ROW_TILED):
        assert feasibility.check(s, forest) is not None
    best, _ = model.choose_strategy(forest, 2000, Calibration.default())
    assert best not in (Strategy.TENSOR, Strategy.ROW_TILED, Strategy.RANK_MXU)


def _trained(trees, depth, cols, rows, seed):
    from tahoe_tpu.forest.train import train_forest

    return train_forest(trees, depth, cols, rows=rows, seed=seed)


@pytest.mark.parametrize("case", [
    "early_leaves", "trained_deep", "finite_sentinel", "exchange_bits",
    "many_trees", "wide", "full_depth12", "trained_deep18",
])
def test_device_engine_cases(case):
    """SparseGatherEngine vs the oracle over the forest classes the SPARSE
    strategy serves. The descent compares f32 values exactly; 1e-5 covers
    the association of the tree sum."""
    missing = float("nan")
    if case == "early_leaves":
        f = synthetic.generate_forest(20, 5, 10, leaf_prob=0.25, seed=1)
    elif case == "trained_deep":
        f = _trained(12, 9, 12, 512, 3)
    elif case == "finite_sentinel":
        missing = -999.0
        f = synthetic.generate_forest(10, 4, 8, leaf_prob=0.2, seed=5,
                                      missing=missing)
    elif case == "exchange_bits":
        f = compiler.hot_child_swap(
            synthetic.generate_forest(12, 5, 9, leaf_prob=0.15, seed=7))
        assert f.exchange.any()
    elif case == "many_trees":
        f = _trained(130, 5, 8, 256, 9)
    elif case == "wide":
        f = synthetic.generate_forest(10, 5, 160, leaf_prob=0.15, seed=21)
    elif case == "full_depth12":
        f = synthetic.generate_forest(8, 12, 10, seed=13)
    else:
        f = _trained(10, 18, 24, 1024, 3)
    d = synthetic.generate_data(48, f.num_cols, missing_prob=0.1, seed=2,
                                missing=missing)
    sf = sparse.from_dense(f)
    got = np.asarray(sparse.SparseGatherEngine(sf).predict(d))
    np.testing.assert_allclose(got, oracle.predict(f, d), atol=1e-5)
    if case.startswith("trained"):
        assert sf.num_nodes < f.num_nodes  # the pool is the true node count


def test_facade_uses_the_gather_descent():
    """Strategy.SPARSE always runs the XLA CSR descent."""
    from tahoe_tpu.config import Strategy
    from tahoe_tpu.engine.forest import Forest

    f = Forest(_trained(20, 9, 12, 512, 20))
    assert isinstance(f.engine(Strategy.SPARSE), sparse.SparseGatherEngine)
