"""CLI smoke test: the full protocol in-process on a tiny fixture (CPU)."""
import numpy as np

from tahoe_tpu import cli
from tahoe_tpu.forest import io, synthetic


def test_cli_protocol(tmp_path, capsys):
    forest = synthetic.generate_forest(12, 4, 8, leaf_prob=0.1, seed=161)
    data = synthetic.generate_data(60, 8, missing_prob=0.1, seed=162)
    mp, dp = str(tmp_path / "model.txt"), str(tmp_path / "data.txt")
    io.save_model(mp, forest)
    io.save_data(dp, data, missing=float("nan"))

    rc = cli.main([
        mp, dp, "--no-isolation", "--no-calibrate",
        "--epochs", "2", "--warmup", "1",
        "--strategies", "HBM_DIRECT", "SPLIT_FOREST",
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Performance model" in out
    assert "results are correct" in out
    assert "speedup" in out or "Best strategy" in out


def test_scaling_validation_runs():
    import subprocess, sys, os

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["TAHOE_PALLAS_INTERPRET"] = "1"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    repo = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
    env["PYTHONPATH"] = repo
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts", "run_scaling.py"),
         "--virtual-devices", "4"],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert '"correct": true' in r.stdout
