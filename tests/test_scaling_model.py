"""Scaling-efficiency predictions (perf_model/scaling.py).

BASELINE config 5: >=85% throughput scaling efficiency to >=2 hosts.
These tests pin the model's algebra; the link numbers are the test's own
(an NVLink-class in-host link and a 100 Gb/s cross-host NIC), not a
machine's measurement.
"""
import pytest

from tahoe_tpu.forest import synthetic
from tahoe_tpu.perf_model.calibrate import Calibration
from tahoe_tpu.perf_model.scaling import predict_scaling

CAL = Calibration(fold_step_ns=0.004, vmem_step_ns=0.004, gather_step_ns=0.01,
                  take_node_ns=0.004, onehot_node_ns=0.008,
                  rank_node_ns=1e-4, dispatch_us=30.0, device_kind="test")
IN_HOST = dict(link_gbps=450.0, hop_latency_s=1e-6, cal=CAL)
CROSS_HOST = dict(link_gbps=12.5, hop_latency_s=5e-6, cal=CAL)


@pytest.fixture(scope="module")
def susy():
    return synthetic.susy_class_forest(seed=0)


def test_two_host_config5_efficiency(susy):
    # 2 hosts x 4 cards, batch over hosts+cards, trees over 2 cards: the
    # BASELINE config-5 shape at a bulk batch. Must clear 85%.
    p = predict_scaling(susy, 131072, n_data=4, n_model=2, **CROSS_HOST)
    assert p.efficiency >= 0.85, p.explain()
    assert p.psum_bytes == 4 * 131072


def test_data_axis_is_free(susy):
    # pure batch sharding: no psum, efficiency limited only by dispatch skew
    p = predict_scaling(susy, 131072, n_data=8, **IN_HOST)
    assert p.psum_bytes == 0 and p.psum_s == 0.0
    assert p.efficiency >= 0.95, p.explain()


def test_psum_cost_monotone_in_bandwidth(susy):
    fast = predict_scaling(susy, 16384, n_data=1, n_model=4, link_gbps=100.0,
                           cal=CAL)
    slow = predict_scaling(susy, 16384, n_data=1, n_model=4, link_gbps=10.0,
                           cal=CAL)
    assert slow.psum_s > fast.psum_s
    assert slow.efficiency <= fast.efficiency


def test_cross_host_slower_than_in_host(susy):
    ici = predict_scaling(susy, 16384, n_data=4, n_model=2, **IN_HOST)
    dcn = predict_scaling(susy, 16384, n_data=4, n_model=2, **CROSS_HOST)
    assert dcn.psum_s > ici.psum_s
    assert dcn.efficiency <= ici.efficiency


def test_single_device_is_unit():
    f = synthetic.generate_forest(64, 6, 12, seed=2)
    p = predict_scaling(f, 4096, **IN_HOST)
    assert p.efficiency == 1.0 and p.psum_s == 0.0 and p.dispatch_s == 0.0
