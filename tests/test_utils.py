"""utils: oracle-parity gate, profiling helpers."""
import numpy as np

from tahoe_tpu.forest import synthetic
from tahoe_tpu.ops.gather_engine import GatherEngine
from tahoe_tpu.utils import debug, profiling


def test_check_engine_pass():
    forest = synthetic.generate_forest(7, 4, 6, leaf_prob=0.1, seed=171)
    data = synthetic.generate_data(30, 6, seed=172)
    rep = debug.check_engine(GatherEngine(forest), forest, data)
    assert rep.correct and rep.num_bad == 0
    assert "correct" in str(rep)


def test_check_engine_detects_corruption():
    forest = synthetic.generate_forest(7, 4, 6, seed=173)
    data = synthetic.generate_data(30, 6, seed=174)
    eng = GatherEngine(forest)
    good = eng.predict  # wrap with corruption

    class Bad:
        def predict(self, d):
            return np.asarray(good(d)) + 1.0

    rep = debug.check_engine(Bad(), forest, data)
    assert not rep.correct and rep.num_bad == 30
    assert "INCORRECT" in str(rep)


def test_call_times_counts_calls():
    import jax.numpy as jnp

    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    ts = profiling.call_times(fn, jnp.ones(4), warmup=2, iters=5)
    assert len(ts) == 5 and len(calls) == 7
    assert all(t >= 0 for t in ts)


def test_time_call_is_median():
    import time

    import jax.numpy as jnp

    def fn(x):
        time.sleep(0.002)
        return x

    t = profiling.time_call(fn, jnp.ones(4), warmup=1, iters=3)
    assert 0.0015 < t < 0.05


def test_compile_cache_honours_the_variable(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing itself."""
    import jax

    from tahoe_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/xla")
    assert compile_cache.enable() == "/elsewhere/xla"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_into_the_checkout(monkeypatch):
    import os

    import jax

    from tahoe_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable()
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".cache", "xla")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
