"""Trained-forest fixtures (forest/train.py): structure + engine parity.

The reference benchmarks forests trained on real datasets; train.py grows
genuinely trained CART ensembles so the engines are exercised on realistic
early-leaf-heavy structure, not random node soups."""
import numpy as np
import pytest

from tahoe_tpu.forest import compiler, synthetic
from tahoe_tpu.forest.train import train_forest
from tahoe_tpu.ops import oracle


@pytest.fixture(scope="module")
def trained():
    spec = train_forest(24, 7, 10, rows=600, seed=11)
    data = synthetic.generate_data(64, 10, missing_prob=0.1, seed=12)
    return spec, data, oracle.predict(spec, data)


def test_trained_structure(trained):
    spec, _, _ = trained
    inner = spec.is_leaf[:, : (1 << spec.depth) - 1]
    assert inner.mean() > 0.2, "trained forest should have early leaves"
    # every tree's root splits on something for this task size
    assert not spec.is_leaf[:, 0].any()


def test_trained_fold_parity(trained):
    from tahoe_tpu.ops.fold_kernel import FoldKernelEngine

    spec, data, want = trained
    eng = FoldKernelEngine(compiler.levelize(spec), row_tile=16,
                           tree_tile=8, interpret=True)
    np.testing.assert_allclose(np.asarray(eng.predict(data)), want, atol=1e-5)


def test_trained_rank_parity(trained):
    from tahoe_tpu.ops.rank_engine import RankEngine

    spec, data, want = trained
    eng = RankEngine(spec)
    np.testing.assert_allclose(np.asarray(eng.predict(data)), want, atol=1e-5)


def test_trained_text_round_trip(tmp_path, trained):
    from tahoe_tpu.forest import io

    spec, data, want = trained
    p = tmp_path / "model.txt"
    io.save_model(str(p), spec)
    spec2 = io.load_model(str(p), num_cols=spec.num_cols,
                          missing=spec.missing)
    spec2 = type(spec2)(**{**spec2.__dict__, "output": spec.output})
    np.testing.assert_allclose(oracle.predict(spec2, data), want, atol=1e-6)
