"""Used-feature compaction + the fold kernel on wide forests.

The reference has no feature ceiling (rows cached whole, Struct.h:416-423 /
the global-mem strategy, Struct.h:1196-1240). Compaction (live-fid remap +
column gather) keeps only live columns; the kernel reads each node's feature
from the row ref, so wide forests hold oracle parity at any width.
"""
import numpy as np
import pytest

from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.fold_kernel import FoldKernelEngine


def _sparse_wide_forest(trees=40, depth=6, num_cols=900, active=70, seed=3,
                        **kw):
    """Forest over `num_cols` columns whose fids hit only `active` of them
    (gisette-class usage: trained forests reference the informative subset)."""
    rng = np.random.default_rng(seed)
    f = synthetic.generate_forest(trees, depth, active, seed=seed, **kw)
    cols = np.sort(rng.choice(num_cols, size=active, replace=False))
    f.fids = cols[f.fids].astype(np.int32)
    f.num_cols = num_cols
    return f


def test_used_features_and_compact():
    f = _sparse_wide_forest()
    used = compiler.used_features(f)
    assert used.size <= 70
    c, idx = compiler.compact_features(f)
    assert idx is not None and c.num_cols == used.size
    assert np.array_equal(idx, used)
    data = synthetic.generate_data(64, 900, missing_prob=0.05, seed=1)
    want = oracle.predict(f, data)
    got = oracle.predict(c, data[:, idx])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_compact_identity_when_all_used():
    f = synthetic.generate_forest(50, 6, 10, seed=0)
    c, idx = compiler.compact_features(f)
    assert idx is None and c is f


def test_fold_engine_auto_compacts_wide_forest():
    f = _sparse_wide_forest(num_cols=900, active=50)
    data = synthetic.generate_data(96, 900, missing_prob=0.05, seed=2)
    want = oracle.predict(f, data)
    eng = FoldKernelEngine(compiler.levelize(f), row_tile=32, tree_tile=32,
                           interpret=True)
    assert eng.col_index is not None
    assert eng.num_cols <= 51  # live fids (+pass-through fid 0)
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("active", [100, 200, 400])
def test_wide_live_features_parity(active):
    """Hundreds of live features: the kernel reads each node's feature from
    the row ref, whatever the width."""
    f = _sparse_wide_forest(trees=24, depth=5, num_cols=max(active, 500),
                            active=active, seed=7)
    data = synthetic.generate_data(64, f.num_cols, missing_prob=0.08, seed=4)
    want = oracle.predict(f, data)
    eng = FoldKernelEngine(compiler.levelize(f), row_tile=32, tree_tile=32,
                           interpret=True)
    assert eng.num_cols <= active + 1
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_wide_deeper_forest():
    f = _sparse_wide_forest(trees=16, depth=7, num_cols=600, active=150,
                            seed=9)
    data = synthetic.generate_data(64, 600, missing_prob=0.02, seed=5)
    want = oracle.predict(f, data)
    eng = FoldKernelEngine(compiler.levelize(f), row_tile=32, tree_tile=64,
                           interpret=True)
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_wide_finite_missing_sentinel():
    f = _sparse_wide_forest(trees=20, depth=5, num_cols=300, active=140,
                            seed=11, missing=-999.0)
    data = synthetic.generate_data(64, 300, missing=-999.0, missing_prob=0.1,
                                   seed=6)
    want = oracle.predict(f, data)
    eng = FoldKernelEngine(compiler.levelize(f), row_tile=32, tree_tile=32,
                           interpret=True)
    got = np.asarray(eng.predict(data))
    np.testing.assert_allclose(got, want, atol=1e-4)
