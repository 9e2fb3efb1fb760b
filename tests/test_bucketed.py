"""Depth-bucketed execution (strategy #7): per-bucket truncation is exact."""
import numpy as np
import pytest

from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.bucketed import (
    DepthBucketedFoldEngine,
    plan_buckets,
    subset_trees,
)


def _mixed_depth_forest(trees=24, stored=7, cols=9, seed=5):
    """Half the trees end by depth 3, a quarter by depth 5, rest full depth —
    all stored complete at ``stored`` (the reference's materialization)."""
    f = synthetic.generate_forest(trees, stored, cols, leaf_prob=0.05,
                                  seed=seed)
    third = trees // 3
    f.is_leaf[:third, f.level_slice(3).start :] = True
    f.is_leaf[third : 2 * third, f.level_slice(5).start :] = True
    return f


def test_plan_buckets_partitions_all_trees():
    depths = np.array([3, 3, 3, 7, 7, 5, 3, 5], np.int32)
    buckets = plan_buckets(depths, max_buckets=3, min_count=1)
    got = np.sort(np.concatenate(buckets))
    assert np.array_equal(got, np.arange(len(depths)))
    # each bucket spans a contiguous depth range
    ranges = sorted((depths[b].min(), depths[b].max()) for b in buckets)
    for (lo1, hi1), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi1 < lo2


def test_plan_buckets_prefers_splitting_deep_tail():
    # 100 shallow + 4 deep trees: one bucket would cost 104 * 2^10; two cost
    # 100 * 2^3 + 8 * 2^10
    depths = np.array([3] * 100 + [10] * 4, np.int32)
    buckets = plan_buckets(depths, max_buckets=4)
    assert len(buckets) == 2
    assert sorted(len(b) for b in buckets) == [4, 100]


def test_subset_trees_round_trip():
    f = _mixed_depth_forest()
    idx = np.array([1, 5, 7], np.int64)
    s = subset_trees(f, idx)
    comp = subset_trees(f, np.setdiff1d(np.arange(f.num_trees), idx))
    assert s.num_trees == 3 and s.depth == f.depth
    data = synthetic.generate_data(40, f.num_cols, seed=6)
    np.testing.assert_allclose(
        oracle.predict_margins(s, data) + oracle.predict_margins(comp, data),
        oracle.predict_margins(f, data),
        atol=1e-4,
    )


@pytest.mark.parametrize("missing_prob", [0.0, 0.15])
def test_bucketed_matches_oracle(missing_prob):
    f = _mixed_depth_forest()
    data = synthetic.generate_data(70, f.num_cols, missing_prob=missing_prob,
                                   seed=7)
    eng = DepthBucketedFoldEngine(f, row_tile=8, tree_tile=16)
    assert len(eng.sub) >= 2  # genuinely bucketed
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, oracle.predict(f, data), atol=1e-5)


def test_bucketed_facade_and_feasibility():
    from tahoe_tpu.config import Strategy
    from tahoe_tpu.engine.forest import Forest

    f = _mixed_depth_forest(seed=8)
    fr = Forest(f)
    assert fr.feasible(Strategy.DEPTH_BUCKETED) is None
    data = synthetic.generate_data(33, f.num_cols, seed=9)
    got = np.asarray(fr.predict(data, Strategy.DEPTH_BUCKETED))
    np.testing.assert_allclose(got, oracle.predict(f, data), atol=1e-5)

    uniform = synthetic.generate_forest(10, 4, 5, seed=10)
    assert "uniform" in Forest(uniform).feasible(Strategy.DEPTH_BUCKETED)


@pytest.mark.parametrize("missing_prob", [0.0, 0.15])
def test_bucketed_rank_matches_oracle(missing_prob):
    """Rank sub-engines under depth bucketing (strategy #6 x #7): one shared
    quantization/transform, per-bucket truncated matrices — still exact."""
    from tahoe_tpu.ops.bucketed import DepthBucketedRankEngine

    f = _mixed_depth_forest()
    data = synthetic.generate_data(70, f.num_cols, missing_prob=missing_prob,
                                   seed=17)
    eng = DepthBucketedRankEngine(f)
    assert len(eng.sub) >= 2  # genuinely bucketed
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, oracle.predict(f, data), atol=1e-5)


def test_bucketed_rank_with_stump_bucket():
    from tahoe_tpu.ops.bucketed import DepthBucketedRankEngine

    f = _mixed_depth_forest(seed=13)
    f.is_leaf[0, :] = True  # tree 0 is a stump -> constant-margin bucket
    data = synthetic.generate_data(40, f.num_cols, seed=14)
    eng = DepthBucketedRankEngine(f)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(f, data), atol=1e-5
    )


def test_make_depth_bucketed_engine_chooses_rank_vs_fold():
    """Fold-kernel buckets where the kernel runs, rank buckets otherwise."""
    from tahoe_tpu.ops.bucketed import (
        DepthBucketedFoldEngine,
        DepthBucketedRankEngine,
        make_depth_bucketed_engine,
    )

    f = _mixed_depth_forest()
    eng = make_depth_bucketed_engine(f, use_kernel=True, row_tile=32)
    assert isinstance(eng, DepthBucketedFoldEngine)
    eng2 = make_depth_bucketed_engine(f, use_kernel=False)
    assert isinstance(eng2, DepthBucketedRankEngine)

    data = synthetic.generate_data(40, f.num_cols, seed=22)
    for e in (eng, eng2):
        np.testing.assert_allclose(
            np.asarray(e.predict(data)), oracle.predict(f, data), atol=1e-5)


def test_bucketed_fold_wide_forest():
    """Buckets share one canonicalization of the live columns."""
    f = _mixed_depth_forest(cols=125, seed=21)
    data = synthetic.generate_data(40, f.num_cols, missing_prob=0.1, seed=23)
    eng = DepthBucketedFoldEngine(f, row_tile=8, tree_tile=16)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(f, data), atol=1e-5)


def test_bucketed_with_early_leaf_stumps():
    """Depth-0 trees (root is a leaf) fold to a compile-time constant."""
    f = _mixed_depth_forest(seed=11)
    f.is_leaf[0, :] = True  # tree 0 is a stump
    data = synthetic.generate_data(25, f.num_cols, seed=12)
    eng = DepthBucketedFoldEngine(f, row_tile=8, tree_tile=16)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(f, data), atol=1e-5
    )
