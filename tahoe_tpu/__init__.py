"""tahoe_tpu: a decision-tree-ensemble inference engine in JAX, run on
NVIDIA GPUs.

A from-scratch framework with the capabilities of the Tahoe CUDA engine
(see SURVEY.md): forest loading from its text model format, structure-aware
model compilation (hot-child swapping, adaptive node encodings, similar-tree
clustering, tree-/node-major layouts), a strategy space of memory placements
realized as XLA programs and one Pallas kernel, an analytical performance
model with measured calibration, exact CPU-oracle parity checking, INT8
node-table quantization, and multi-device scaling via jax.sharding.
"""
from tahoe_tpu.config import (
    ALL_STRATEGIES,
    MISSING_EPS,
    ORACLE_ATOL,
    NodeWidth,
    Output,
    PredictConfig,
    Strategy,
)
from tahoe_tpu.forest.spec import ForestSpec, LeveledForest, PackedForest
from tahoe_tpu.forest import io, synthetic

__version__ = "0.1.0"

__all__ = [
    "ALL_STRATEGIES",
    "MISSING_EPS",
    "ORACLE_ATOL",
    "ForestSpec",
    "LeveledForest",
    "NodeWidth",
    "Output",
    "PackedForest",
    "PredictConfig",
    "Strategy",
    "io",
    "synthetic",
    "__version__",
]
