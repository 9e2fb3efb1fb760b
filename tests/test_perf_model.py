"""Analytical performance model: its algebra and its feasibility skips.

The reference validates its cost model by comparing the predicted strategy
with the enumerated best (main.cu:85-92); the CLI and the sweep do that on
the card. These tests pin the model's algebra with calibrations built here,
so they test the model and not a machine.
"""
import dataclasses

import pytest

from tahoe_tpu.config import Strategy
from tahoe_tpu.forest import synthetic
from tahoe_tpu.perf_model import model
from tahoe_tpu.perf_model.calibrate import Calibration

BASE = Calibration(fold_step_ns=1.0, vmem_step_ns=1.0, gather_step_ns=1.0,
                   take_node_ns=1.0, onehot_node_ns=1.0, rank_node_ns=1.0,
                   dispatch_us=10.0, device_kind="test")
TINY = 1e-6


@pytest.fixture(scope="module")
def susy():
    return synthetic.generate_forest(64, 8, 18, seed=1)


@pytest.mark.parametrize("field,want", [
    ("fold_step_ns", Strategy.SPLIT_FOREST),
    ("vmem_step_ns", Strategy.VMEM_FOREST),
    ("gather_step_ns", Strategy.HBM_DIRECT),
    ("take_node_ns", Strategy.ROW_TILED),
    ("onehot_node_ns", Strategy.TENSOR),
    ("rank_node_ns", Strategy.RANK_MXU),
])
def test_cheapest_family_wins(susy, field, want):
    cal = dataclasses.replace(BASE, **{field: TINY})
    best, costs = model.choose_strategy(susy, 4096, cal, platform="gpu")
    assert best == want, {s.name: c and c.total for s, c in costs.items()}


@pytest.mark.parametrize("strategy", [
    Strategy.HBM_DIRECT, Strategy.SPARSE, Strategy.ROW_TILED, Strategy.TENSOR,
    Strategy.SPLIT_FOREST, Strategy.RANK_MXU,
])
def test_compute_is_linear_in_rows(susy, strategy):
    one = model.predict_cost(strategy, susy, 1000, BASE, platform="gpu")
    two = model.predict_cost(strategy, susy, 2000, BASE, platform="gpu")
    assert two.compute_s == pytest.approx(2 * one.compute_s)
    assert two.dispatch_s == one.dispatch_s == BASE.dispatch_us / 1e6


def test_work_shapes(susy):
    """Descents pay trees x depth per row; the leveled and rank forms pay
    trees x 2^depth."""
    rows, T, D = 100, susy.num_trees, susy.depth
    cost = {s: model.predict_cost(s, susy, rows, BASE, platform="gpu")
            for s in Strategy}
    assert cost[Strategy.SPLIT_FOREST].compute_s == pytest.approx(
        rows * T * D * 1e-9)
    assert cost[Strategy.HBM_DIRECT].compute_s == pytest.approx(
        rows * T * (D + 1) * 1e-9)
    assert cost[Strategy.ROW_TILED].compute_s == pytest.approx(
        rows * T * (1 << D) * 1e-9)
    assert cost[Strategy.RANK_MXU].compute_s == pytest.approx(
        rows * T * ((1 << D) - 1) * 1e-9)  # 18 features: one plane group


def test_kernel_strategies_skipped_off_gpu(susy, monkeypatch):
    monkeypatch.delenv("TAHOE_PALLAS_INTERPRET", raising=False)
    for s in (Strategy.VMEM_FOREST, Strategy.SPLIT_FOREST):
        assert model.predict_cost(s, susy, 100, BASE, platform="cpu") is None
        assert model.predict_cost(s, susy, 100, BASE, platform="gpu")
    best, _ = model.choose_strategy(
        susy, 100, dataclasses.replace(BASE, fold_step_ns=TINY,
                                       vmem_step_ns=TINY), platform="cpu")
    assert best not in (Strategy.VMEM_FOREST, Strategy.SPLIT_FOREST)


def test_depth_bucketed_mirrors_engine_choice(monkeypatch):
    """DEPTH_BUCKETED prices fold buckets where the kernel runs, rank buckets
    where it does not — the choice make_depth_bucketed_engine makes."""
    f = synthetic.generate_mixed_depth_forest(40, 8, 10, min_depth=3, seed=4)
    fold_only = dataclasses.replace(BASE, rank_node_ns=0.0)
    monkeypatch.delenv("TAHOE_PALLAS_INTERPRET", raising=False)
    on_gpu = model.predict_cost(Strategy.DEPTH_BUCKETED, f, 100, fold_only,
                                platform="gpu")
    on_cpu = model.predict_cost(Strategy.DEPTH_BUCKETED, f, 100, fold_only,
                                platform="cpu")
    assert on_gpu.compute_s > 0 and on_cpu.compute_s == 0.0


def test_infeasible_strategies_priced_none():
    deep = synthetic.generate_forest(4, 16, 6, seed=2)
    for s in (Strategy.TENSOR, Strategy.ROW_TILED):
        assert model.predict_cost(s, deep, 100, BASE, platform="gpu") is None
    assert model.predict_cost(Strategy.SPARSE, deep, 100, BASE,
                              platform="gpu") is not None


def test_cost_breakdown_fields():
    spec = synthetic.generate_forest(64, 6, 12, seed=2)
    cb = model.predict_cost(Strategy.RANK_MXU, spec, 2048, BASE)
    assert cb.compute_s > 0 and cb.dispatch_s > 0 and cb.memory_s >= 0
    assert cb.total == cb.compute_s + cb.memory_s + cb.dispatch_s


def test_default_calibration_names_its_card():
    cal = Calibration.default()
    assert "H100" in cal.device_kind
    assert all(getattr(cal, f.name) > 0 for f in dataclasses.fields(cal)
               if f.name != "device_kind")
