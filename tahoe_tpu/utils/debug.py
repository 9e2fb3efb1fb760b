"""Debug & validation modes.

The reference has no sanitizers (SURVEY.md §5); its one gate is the on-device
oracle compare (compare_GPU, cuda_base.h:98-111). Equivalents here:

- :func:`check_engine` — the oracle-parity gate as a library call, with a
  per-row report instead of a printf;
- interpreter mode — the Pallas fold kernel takes ``interpret=True`` (or
  ``TAHOE_PALLAS_INTERPRET=1``) to run un-compiled for debugging (the
  Pallas analog of nvcc -G builds, Makefile:8);
- :func:`nan_guard` — jax debug_nans scope for hunting NaN sources.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

from tahoe_tpu.config import ORACLE_ATOL
from tahoe_tpu.forest.spec import ForestSpec
from tahoe_tpu.ops import oracle


@dataclasses.dataclass
class ParityReport:
    correct: bool
    max_err: float
    num_bad: int
    worst_rows: list

    def __str__(self):
        verdict = "correct" if self.correct else "INCORRECT"
        return (
            f"Results are {verdict}: max |err| = {self.max_err:.3e} "
            f"(tol {ORACLE_ATOL}), {self.num_bad} rows out of tolerance"
        )


def check_engine(engine, forest: ForestSpec, data,
                 atol: float = ORACLE_ATOL) -> ParityReport:
    """Compare an engine's predictions against the CPU oracle."""
    got = np.asarray(engine.predict(data))
    want = oracle.predict(forest, np.asarray(data))
    err = np.abs(got - want)
    bad = np.flatnonzero(err > atol)
    worst = bad[np.argsort(err[bad])[::-1]][:10].tolist() if bad.size else []
    return ParityReport(
        correct=bool(bad.size == 0),
        max_err=float(err.max(initial=0.0)),
        num_bad=int(bad.size),
        worst_rows=worst,
    )


@contextlib.contextmanager
def nan_guard():
    """Raise on any NaN produced inside the scope (jax debug_nans)."""
    import jax

    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
