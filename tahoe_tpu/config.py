"""Core enums and configuration dataclasses.

Re-design of the reference's enums/params (reference: Struct.h:23-42
``algo_t``/``strategy_t``/``output_t``, Struct.h:120-189 param structs). The
reference mutates two globals (``selected_algorithm`` Struct.h:11,
``adaptive_format_number`` Struct.h:9); here everything is explicit, immutable
configuration — no global state.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import os


class Output(enum.IntFlag):
    """Output transform flags (same numeric values as Struct.h:37-42).

    Applied in fixed order after margin accumulation: AVG (divide by num_trees),
    add global_bias, SIGMOID, THRESHOLD (reference: Struct.h:196-209 transform_k,
    BaseTahoeTest.h:465-472 CPU oracle).
    """

    RAW = 0x0
    AVG = 0x1
    SIGMOID = 0x10
    THRESHOLD = 0x100

    @staticmethod
    def validate(flags: int) -> None:
        all_set = Output.AVG | Output.SIGMOID | Output.THRESHOLD
        if flags & ~int(all_set):
            raise ValueError(
                f"output must be a combination of RAW, AVG, SIGMOID, THRESHOLD; got {flags:#x}"
            )


class Strategy(enum.Enum):
    """Memory-placement strategies for forest traversal.

    The renditions of the reference's five enumerated kernels
    (``selected_algorithm`` 0-4, dispatched at Struct.h:2168-2179, printed as
    "strategy 1-5" at BaseTahoeTest.h:682), by *memory placement*:

    ===============  ==================================  =========================
    This framework   Reference (strategy #, kernel)      Placement
    ===============  ==================================  =========================
    HBM_DIRECT       1  infer_adaptive_reorg_*           node tables in device
                                                         memory, XLA gathers
    ROW_TILED        2  infer_k_shared_data_wo_adaptive  row chunks, select-fold
                                                         over whole levels (XLA)
    TENSOR           3  infer_k_shared_data_adaptive     row chunks, one-hot
                                                         feature select (XLA)
    VMEM_FOREST      4  infer_k_shared_forest_adaptive   fold kernel, one block
                                                         walks the whole forest
    SPLIT_FOREST     5  infer_k_split_forest_adaptive    fold kernel, one block
                                                         per tree chunk, partial
                                                         margins summed by XLA
    ===============  ==================================  =========================

    VMEM_FOREST and SPLIT_FOREST run the Triton-route Pallas kernel of
    ops/fold_kernel.py; the names are kept for the CLI's and the records'
    numbering.
    """

    HBM_DIRECT = 1
    ROW_TILED = 2
    TENSOR = 3
    VMEM_FOREST = 4
    SPLIT_FOREST = 5
    # Framework-native sixth strategy, the successor of the reference's
    # adaptive compressed node format (Struct.h:1827-1852): node tables
    # rank-quantized to int8 and traversed by int8 matrix products
    # (ops/rank_engine.py).
    RANK_MXU = 6
    # Framework-native seventh strategy: trees bucketed by per-tree REACHABLE
    # depth, each bucket run at its own (truncated) depth in one jit, margins
    # summed (ops/bucketed.py). Successor of the reference's similar-tree
    # clustering (Struct.h:1854-1891).
    DEPTH_BUCKETED = 7
    # CSR sparse descent (forest/sparse.py): pruned node pool in device
    # memory, level-synchronous masked gather advance. The realization of the
    # reference's dormant sparse path (sparse_forest + infer_sparse,
    # Struct.h:2217-2353; dense2sparse commented out at
    # BaseTahoeTest.h:728-846). Its storage is the TRUE node count, so very
    # deep trained ensembles stay storable.
    SPARSE = 8

    @property
    def strategy_number(self) -> int:
        """1-based strategy id matching the reference's printed numbering."""
        return self.value


ALL_STRATEGIES = tuple(Strategy)


class NodeWidth(enum.IntEnum):
    """Adaptive node-metadata width in bytes (reference: Struct.h:1827-1852).

    The reference packs {fid, def_left, is_leaf, exchange} into a char/short/int
    chosen by the bits needed for the max feature id (5/13/29 usable fid bits).
    We keep the same three widths for the packed ``bits`` table (int8/int16/int32).
    """

    CHAR = 1   # fid fits in 5 bits  (<= 31 features)
    SHORT = 2  # fid fits in 13 bits (<= 8191 features)
    INT = 4    # fid fits in 29 bits

    @staticmethod
    def for_max_fid(max_fid: int) -> "NodeWidth":
        # Reference computes fid_len = (log2(max_fid) + 3)/8 and buckets it
        # (Struct.h:1836-1852); equivalently: pick the narrowest packing whose
        # fid field holds max_fid.
        if max_fid < (1 << 5):
            return NodeWidth.CHAR
        if max_fid < (1 << 13):
            return NodeWidth.SHORT
        if max_fid < (1 << 29):
            return NodeWidth.INT
        raise ValueError(f"max feature id {max_fid} exceeds 29-bit fid field")

    @property
    def fid_bits(self) -> int:
        return {1: 5, 2: 13, 4: 29}[int(self)]


# Bit layout of the packed adaptive node word, per width W in {8, 16, 32} bits:
#   [fid : W-3 bits][def_left : 1][is_leaf : 1][exchange : 1]
# (reference masks: Struct.h:61-75)
def fid_mask(width: NodeWidth) -> int:
    return (1 << width.fid_bits) - 1


def def_left_mask(width: NodeWidth) -> int:
    return 1 << width.fid_bits


def is_leaf_mask(width: NodeWidth) -> int:
    return 1 << (width.fid_bits + 1)


def exchange_mask(width: NodeWidth) -> int:
    return 1 << (width.fid_bits + 2)


def tree_num_nodes(depth: int) -> int:
    """Nodes in a complete binary tree of the given depth (Struct.h:15-17)."""
    return (1 << (depth + 1)) - 1


def forest_num_nodes(num_trees: int, depth: int) -> int:
    """Total nodes in a forest of complete trees (Struct.h:19-21)."""
    return num_trees * tree_num_nodes(depth)


# Missing-value tolerance: a feature value x is "missing" when
# |x - missing_sentinel| <= MISSING_EPS (reference: Struct.h:380-383,
# BaseTahoeTest.h:452). When the sentinel itself is NaN the check is isnan(x)
# (synthetic-data path, Struct.h:518).
MISSING_EPS = 1.0e-6

# Output tolerance for oracle-parity checks (reference: cuda_base.h:103).
ORACLE_ATOL = 1.0e-3


@dataclasses.dataclass(frozen=True)
class PredictConfig:
    """Per-call inference configuration (analog of predict_params, Struct.h:137-160)."""

    strategy: Strategy = Strategy.TENSOR
    # Row-tile size for engines that internally chunk the batch.
    row_tile: int = 256
    # Tree-chunk size for SPLIT_FOREST.
    tree_chunk: int = 64
    # Use the int8 rank-quantized node tables when the forest carries them.
    use_quantized: bool = False

    def __post_init__(self):
        if self.row_tile <= 0 or self.tree_chunk <= 0:
            raise ValueError("row_tile and tree_chunk must be positive")


def pallas_interpret() -> bool:
    """Whether Pallas kernels run under the Pallas interpreter.

    Only when ``TAHOE_PALLAS_INTERPRET=1`` asks for it (the CPU test suite
    sets it). Otherwise a kernel is compiled for the GPU it runs on, and
    feasibility reports it unavailable on any other platform."""
    return os.environ.get("TAHOE_PALLAS_INTERPRET", "") == "1"


def sigmoid(x: float) -> float:
    """Scalar sigmoid used by host-side transforms (Struct.h:13)."""
    return 1.0 / (1.0 + math.exp(-x))
