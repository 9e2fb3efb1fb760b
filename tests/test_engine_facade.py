"""Forest facade + strategy enumeration + perf model plumbing."""
import numpy as np
import pytest

from tahoe_tpu.config import Strategy
from tahoe_tpu.engine import autotune, feasibility
from tahoe_tpu.engine.forest import Forest
from tahoe_tpu.forest import io, synthetic
from tahoe_tpu.perf_model import calibrate, model


@pytest.fixture(scope="module")
def forest():
    spec = synthetic.generate_forest(20, 4, 10, leaf_prob=0.15, seed=91)
    return Forest(spec)


@pytest.fixture(scope="module")
def data():
    return synthetic.generate_data(40, 10, missing_prob=0.1, seed=92)


@pytest.mark.parametrize("strategy", list(Strategy))
def test_all_strategies_match_oracle(forest, data, strategy):
    reason = forest.feasible(strategy)
    if reason is not None:
        pytest.skip(reason)
    preds = np.asarray(forest.predict(data, strategy))
    want = forest.predict_oracle(data)
    np.testing.assert_allclose(preds, want, atol=1e-5)


def test_from_files_round_trip(tmp_path, data):
    spec = synthetic.generate_forest(6, 3, 10, seed=93)
    mp = str(tmp_path / "m.txt")
    dp = str(tmp_path / "d.txt")
    io.save_model(mp, spec)
    io.save_data(dp, data, missing=float("nan"))
    f = Forest.from_files(mp, dp)
    assert f.spec.num_trees == 6
    assert f.spec.num_cols == 10
    np.testing.assert_allclose(
        np.asarray(f.predict(data, Strategy.HBM_DIRECT)),
        f.predict_oracle(data), atol=1e-5,
    )


def test_feasibility_deep_forest():
    deep = synthetic.generate_forest(2, 16, 5, seed=94)
    assert feasibility.check(Strategy.TENSOR, deep) is not None
    assert feasibility.check(Strategy.HBM_DIRECT, deep) is None


def test_perf_model_costs():
    spec = synthetic.generate_forest(50, 6, 12, seed=95)
    cal = calibrate.Calibration.default()
    best, costs = model.choose_strategy(spec, 10000, cal)
    assert best in Strategy
    for s, c in costs.items():
        if c is not None:
            assert c.total > 0


def test_enumeration_in_process(forest, data):
    spec = forest.spec
    results = autotune.enumerate_strategies(
        spec, data,
        strategies=(Strategy.HBM_DIRECT, Strategy.ROW_TILED, Strategy.SPLIT_FOREST),
        subprocess_isolation=False, warmup=1, epochs=2, verbose=False,
    )
    for s, r in results.items():
        assert r.ran, f"{s}: {r.error or r.skipped_reason}"
        assert r.correct
    assert autotune.best_strategy(results) is not None


def test_enumeration_subprocess(forest, data):
    """One strategy through the real subprocess path (CPU backend)."""
    results = autotune.enumerate_strategies(
        forest.spec, data,
        strategies=(Strategy.HBM_DIRECT,),
        subprocess_isolation=True, warmup=1, epochs=2, verbose=False,
    )
    r = results[Strategy.HBM_DIRECT]
    assert r.ran and r.correct, (r.error, r.skipped_reason)


def test_kernel_feasibility_follows_the_platform(monkeypatch):
    """The fold kernel is feasible on a GPU, or interpreted when asked;
    never on another platform."""
    spec = synthetic.generate_forest(20, 4, 10, seed=96)
    monkeypatch.delenv("TAHOE_PALLAS_INTERPRET", raising=False)
    for s in (Strategy.VMEM_FOREST, Strategy.SPLIT_FOREST):
        assert feasibility.check(s, spec, platform="gpu") is None
        assert "GPU" in feasibility.check(s, spec, platform="cpu")
    for s in (Strategy.HBM_DIRECT, Strategy.RANK_MXU, Strategy.TENSOR):
        assert feasibility.check(s, spec, platform="cpu") is None
    monkeypatch.setenv("TAHOE_PALLAS_INTERPRET", "1")
    assert feasibility.check(Strategy.SPLIT_FOREST, spec, "cpu") is None


def test_placements_of_the_fold_strategies(forest):
    """VMEM_FOREST walks the whole forest per program (one tree chunk);
    SPLIT_FOREST splits it into 128-tree chunks."""
    big = Forest(synthetic.generate_forest(300, 3, 6, seed=97))
    vm = big.engine(Strategy.VMEM_FOREST)
    sp = big.engine(Strategy.SPLIT_FOREST)
    assert vm.cfg.padded_trees == vm.cfg.chunk_trees >= 300
    assert sp.cfg.chunk_trees == 128 and sp.cfg.padded_trees == 384
    assert forest.engine(Strategy.SPLIT_FOREST) is forest.engine(
        Strategy.SPLIT_FOREST)  # engines are cached per key


def test_child_platform_keeps_the_caller_off_the_device():
    """The CLI parent learns the platform from a child process."""
    assert autotune.child_platform() == "cpu"
