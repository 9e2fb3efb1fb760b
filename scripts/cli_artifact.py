"""End-to-end CLI artifact: trained forest → text files → full CLI protocol.

The reference's actual user journey is ``./Tahoe MODEL DATA`` over a
downloaded trained model (main.cu:7-17, run_all_15_examples.sh); this drives
the same file-to-verdict path on the GPU: forest/train.py CART ensemble →
io.save_model/save_data (byte-compatible reference text formats) →
``python -m tahoe_tpu.cli`` → transcript on stdout.

Usage:
  python scripts/cli_artifact.py > cli_run.txt 2>&1
  python scripts/cli_artifact.py --wide > cli_run_wide.txt   # 200 features
"""
from __future__ import annotations

import os
import sys
import tempfile


def main() -> int:
    import numpy as np

    from tahoe_tpu.forest import io, synthetic
    from tahoe_tpu.forest.train import train_forest

    wide = "--wide" in sys.argv[1:]
    tmp = tempfile.mkdtemp(prefix="tahoe_fixture_")
    mp = os.path.join(tmp, "model_rf.txt")
    dp = os.path.join(tmp, "data_rf.txt")

    if wide:
        # a trained 200-feature forest through the CLI protocol. Labels
        # are variance-normalized: train_forest's default task has
        # z = X @ proj with Var[z] ∝ num_cols, so at 200 features raw leaf
        # values reach O(1e3-1e4) and the reference's ABSOLUTE 1e-3
        # tolerance (BaseTahoeTest.h:521-530) lands at f32 summation noise
        # for a 150-term AVG; every reference dataset's outputs are O(1)
        # margins, so the fixture's must be too.
        def unit_scale_task(X, rng):
            proj = rng.standard_normal((X.shape[1], 3))
            z = (X @ proj) / np.sqrt(X.shape[1])
            y = (np.sin(z[:, 0]) + 0.5 * np.sign(z[:, 1]) * z[:, 1] ** 2
                 + 0.3 * z[:, 2] + 0.1 * rng.standard_normal(X.shape[0]))
            return y

        spec = train_forest(150, 8, 200, rows=4096, seed=7,
                            task_fn=unit_scale_task)
        data = synthetic.generate_data(4000, 200, missing_prob=0.01, seed=8)
    else:
        spec = train_forest(200, 10, 24, rows=4096, seed=7)
        data = synthetic.generate_data(4000, 24, missing_prob=0.01, seed=8)
    io.save_model(mp, spec)
    io.save_data(dp, data.astype(np.float32), float(spec.missing))
    print(f"fixture: trained forest {spec.num_trees} trees depth "
          f"{spec.depth} -> {mp}; {data.shape[0]} rows -> {dp}", flush=True)

    from tahoe_tpu import cli

    return cli.main([mp, dp, "--epochs", "30"])


if __name__ == "__main__":
    sys.exit(main())
