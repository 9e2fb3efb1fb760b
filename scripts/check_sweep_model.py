#!/usr/bin/env python
"""Offline model-vs-sweep validation (no chip needed).

Re-runs the analytical performance model (perf_model.choose_strategy) with
the CURRENT code against the measured strategy tables of a sweep jsonl
(scripts/run_sweep.py, measured on a GPU), reporting strict argmin agreement
and the 5% noise-band view — the reference's "model predicts correctly"
criterion (main.cu:85-90) applied retroactively, so model changes can be
validated against the measured record without re-running the sweep.

Synthetic families are rebuilt from run_sweep.SHAPES by dataset name, so
the spec the model sees is bit-identical to what the sweep measured
(seeded generators).

Usage: JAX_PLATFORMS=cpu python scripts/check_sweep_model.py sweep_results.jsonl
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def build_spec(name: str):
    """Spec via run_sweep.family_spec — the SAME constructor the sweep used
    (no duplicated generation logic to desynchronize). Returns None for
    labels that aren't synthetic families (file-based --data-dir records)."""
    from run_sweep import SHAPES, family_spec

    for shape in SHAPES:
        if shape[0] == name:
            return family_spec(shape)
    return None


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    path = sys.argv[1] if len(sys.argv) > 1 else "sweep_results.jsonl"
    from tahoe_tpu.perf_model import calibrate, model

    cal = calibrate.Calibration.default()

    latest = {}
    for line in open(path):
        r = json.loads(line)
        latest[r["dataset"]] = r  # last record per family wins

    strict = within5 = n = 0
    for name, rec in sorted(latest.items()):
        meas = {k: v for k, v in rec["strategies"].items() if v is not None}
        # the record's own measured_best is parity-filtered
        # (autotune.best_strategy keeps only correct strategies) — never
        # recompute it from raw times, a fast-but-wrong strategy would win
        best = rec.get("measured_best")
        if not meas or best not in meas:
            continue
        spec = build_spec(name)
        if spec is None:
            print(f"--- {name}: not a synthetic family, skipped")
            continue
        # the sweep ran on a GPU: price the strategies that exist there
        pred, _ = model.choose_strategy(spec, rec["rows"], cal, "gpu")
        ok = pred.name == best
        ok5 = ok or (pred.name in meas
                     and meas[pred.name] <= meas[best] * 1.05)
        n += 1
        strict += ok
        within5 += ok5
        flag = "OK " if ok else ("~5%" if ok5 else "MISS")
        bands = rec.get("bands") or {}
        band_note = ""
        if not ok and pred.name in meas:
            b_pred, b_best = bands.get(pred.name), bands.get(best)
            if b_pred and b_best and b_pred[0] <= b_best[1] and b_best[0] <= b_pred[1]:
                band_note = " (bands overlap — measured tie)"
        print(f"{flag} {name:22s} predicted {pred.name:13s} "
              f"measured-best {best:13s} "
              f"({meas.get(pred.name, float('nan')):.4f} vs "
              f"{meas[best]:.4f} us){band_note}")
    print(f"\nmodel vs {os.path.basename(path)}: {strict}/{n} strict, "
          f"{within5}/{n} within 5%")
    return 0 if within5 == n else 1


if __name__ == "__main__":
    sys.exit(main())
