"""Predicted multi-device / multi-host scaling efficiency from psum bytes.

BASELINE config 5 asks for >=85% throughput scaling efficiency to >=2 hosts.
This is the analytical bound with the math shown; ``scripts/run_scaling.py``
measures the real thing on the devices that exist.

The model (weak scaling, ``rows_per_device`` constant):

- Batch sharding ("data" axis) is communication-free: every device runs the
  identical single-device program on its own rows; the only added cost is
  the per-call dispatch.
- Tree sharding ("model" axis over n devices) keeps all rows on every device
  but 1/n of the trees; after traversal ONE f32 psum of per-row margins runs
  over the axis (sharded.py — the cross-device DeviceSegmentedReduce,
  Struct.h:655-659). Ring all-reduce cost of B = 4*rows_local bytes:

      T_psum = 2 * (n-1)/n * B / bw + (n-1) * hop_latency

  where ``bw`` is the per-link collective bandwidth of the slowest hop of
  the ring. Per-device time T(n) = T_comp(1)/n_model + T_psum, and
  weak-scaling efficiency vs one device running the whole forest on the
  same rows is eff = T_comp(1) / (n_model * T(n)).

The link's bandwidth and hop latency are arguments: the caller states what
it measured (or the interconnect it plans for); the model assumes none.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from tahoe_tpu.forest.spec import ForestSpec
from tahoe_tpu.perf_model.calibrate import Calibration
from tahoe_tpu.perf_model.model import choose_strategy


@dataclasses.dataclass(frozen=True)
class ScalingPrediction:
    n_devices: int
    n_data: int
    n_model: int
    link_gbps: float
    compute_s: float        # single-device full-forest time on rows_per_device
    psum_bytes: int         # per-device all-reduce payload
    psum_s: float
    dispatch_s: float
    efficiency: float       # throughput scaling efficiency vs 1 device

    def explain(self) -> str:
        return (
            f"mesh=({self.n_data} data x {self.n_model} model), "
            f"T_comp(1)={self.compute_s*1e6:.1f} us, "
            f"psum {self.psum_bytes} B -> {self.psum_s*1e6:.2f} us "
            f"({self.link_gbps:g} GB/s link), "
            f"eff={self.efficiency:.1%}"
        )


def predict_scaling(forest: ForestSpec, rows_per_device: int,
                    n_data: int = 1, n_model: int = 1, *,
                    link_gbps: float, hop_latency_s: float = 0.0,
                    cal: Optional[Calibration] = None) -> ScalingPrediction:
    """Weak-scaling efficiency for a (data, model) mesh whose model-axis
    psum rides a link of ``link_gbps`` GB/s and ``hop_latency_s`` per hop.
    The data axis never communicates, so only dispatch skew charges it.
    """
    cal = cal or Calibration.default()
    _, costs = choose_strategy(forest, rows_per_device, cal)
    best = min((c for c in costs.values() if c is not None),
               key=lambda c: c.total)
    t1 = best.total  # one device, whole forest, rows_per_device rows

    n = n_data * n_model
    psum_bytes = 0
    psum_s = 0.0
    if n_model > 1:
        psum_bytes = 4 * rows_per_device
        psum_s = 2.0 * (n_model - 1) / n_model * psum_bytes / (
            link_gbps * 1e9) + (n_model - 1) * hop_latency_s
    # dispatch skew: multi-host launch adds ~one extra dispatch of slack
    dispatch_s = cal.dispatch_us / 1e6 if n > 1 else 0.0

    # per-device wall time with 1/n_model of the trees (compute and memory
    # terms both shrink with the tree count; dispatch does not)
    t_n = (t1 - best.dispatch_s) / n_model + best.dispatch_s \
        + psum_s + dispatch_s
    # Efficiency = Throughput(n) / (n * Throughput(1)).  Rows shard over
    # "data" only (R = n_data * rows_per_device), so
    #   Throughput(n) = n_data * rows_per_device / t_n
    #   Throughput(1) = rows_per_device / t1
    # -> eff = t1 / (n_model * t_n); the data axis cancels (zero comm).
    eff = min(1.0, t1 / (n_model * t_n))
    return ScalingPrediction(
        n_devices=n, n_data=n_data, n_model=n_model, link_gbps=link_gbps,
        compute_s=t1, psum_bytes=psum_bytes, psum_s=psum_s,
        dispatch_s=dispatch_s, efficiency=eff,
    )
