"""Per-strategy feasibility predicates.

The reference pre-checks shared-memory feasibility before benchmarking
strategies 4/5 and skips infeasible ones with acc=FLT_MAX
(BaseTahoeTest.h:657-679; hard asserts in kernels, Struct.h:550-552). Here a
strategy is infeasible when it cannot lower on the platform, or when its
tables would not fit device memory:

- the fold kernel (VMEM_FOREST, SPLIT_FOREST) is a Triton-route Pallas
  kernel: it compiles for a GPU only, or runs under the Pallas interpreter
  when config.pallas_interpret() asks for it. Its tables stay in device
  memory (L1/L2 hold the chunk being walked), so their size is the limit;
- every other strategy is plain XLA, limited by the size of what it
  materializes.

``platform`` names the JAX platform the strategy would run on. A caller that
must not initialise a backend itself (the CLI's parent process) passes it;
otherwise ``jax.default_backend()`` is asked.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from tahoe_tpu.config import Strategy, forest_num_nodes, pallas_interpret
from tahoe_tpu.forest.spec import ForestSpec

# Cap on the node tables any one engine uploads (complete-tree storage).
TABLE_BYTES_CAP = 2 << 30
# Strategies realized by the Pallas fold kernel (ops/fold_kernel.py).
KERNEL_STRATEGIES = (Strategy.VMEM_FOREST, Strategy.SPLIT_FOREST)


def kernel_unavailable(platform: Optional[str] = None) -> Optional[str]:
    """None when the Pallas fold kernel can run here, else the reason."""
    if pallas_interpret():
        return None
    if platform is None:
        import jax

        platform = jax.default_backend()
    if platform != "gpu":
        return (f"the fold kernel is compiled by Triton for a GPU; platform "
                f"is {platform} (TAHOE_PALLAS_INTERPRET=1 interprets it)")
    return None


def check(strategy: Strategy, forest: ForestSpec,
          platform: Optional[str] = None) -> Optional[str]:
    """None if feasible, else a human-readable reason (the strategy is then
    skipped with cost=inf, mirroring the reference's acc=FLT_MAX)."""
    dense_bytes = forest_num_nodes(forest.num_trees, forest.depth) * 8
    if strategy in KERNEL_STRATEGIES:
        reason = kernel_unavailable(platform)
        if reason is not None:
            return reason
    if strategy in KERNEL_STRATEGIES or strategy == Strategy.HBM_DIRECT:
        # complete-tree tables grow with depth whatever the real node count
        # (Struct.h:19-21 pays the same)
        if dense_bytes > TABLE_BYTES_CAP:
            return (f"dense node tables ~{dense_bytes / 2**30:.1f} GiB "
                    f"(complete-tree storage at depth {forest.depth})")
    if strategy in (Strategy.TENSOR, Strategy.ROW_TILED):
        # leveled form materializes 2^depth leaves per tree and row
        if forest.depth > 14:
            return f"leveled form of depth {forest.depth} is too large"
    if strategy == Strategy.SPARSE:
        from tahoe_tpu.forest.compiler import reachable_mask

        pool = int(reachable_mask(forest).sum())
        if pool * 16 > TABLE_BYTES_CAP:
            return f"sparse node pool ~{pool * 16 / 2**30:.1f} GiB"
    if strategy == Strategy.DEPTH_BUCKETED:
        from tahoe_tpu.forest.compiler import reachable_depths

        if np.unique(reachable_depths(forest)).size < 2:
            return "uniform tree depth — identical work to SPLIT_FOREST"
        if kernel_unavailable(platform) is not None:
            return check(Strategy.RANK_MXU, forest, platform)
    if strategy == Strategy.RANK_MXU:
        from tahoe_tpu.forest.compiler import RANK_MAX_COLS

        # the engine compacts to live features, and features with too many
        # distinct thresholds split into banded virtual features
        # (quantize.band_split); the bands must fit the plane groups
        vcols = rank_virtual_cols(forest)
        if vcols > RANK_MAX_COLS:
            return (f"forest needs {vcols} banded virtual live features "
                    f"> {RANK_MAX_COLS}")
        # int8 matrices: 128 bytes per node and plane group
        from tahoe_tpu.forest.compiler import rank_groups

        mat_bytes = dense_bytes // 8 * 128 * rank_groups(vcols)
        if mat_bytes > 4 * TABLE_BYTES_CAP:
            return (f"int8 rank matrices ~{mat_bytes / 2**30:.1f} GiB at "
                    f"depth {forest.depth}")
    return None


def rank_virtual_cols(forest: ForestSpec) -> int:
    """Virtual feature count after rank band splitting over LIVE features
    (= live count when every feature has <= RANK_MAX distinct thresholds).

    Single lexsort over internal (fid, threshold) pairs instead of a per-
    feature unique() — the per-feature loop was O(F * nodes) and gisette-class
    forests have thousands of columns."""
    from tahoe_tpu.forest.compiler import RANK_MAX, reachable_mask

    internal = ~forest.is_leaf & reachable_mask(forest)
    if not internal.any():
        return 1
    f = forest.fids[internal].ravel()
    v = forest.values[internal].ravel()
    order = np.lexsort((v, f))
    fs, vs = f[order], v[order]
    new = np.ones(fs.size, bool)
    new[1:] = (fs[1:] != fs[:-1]) | (vs[1:] != vs[:-1])
    k = np.bincount(fs[new], minlength=forest.num_cols)
    live = np.unique(fs)
    return int(sum(max(1, -(-int(k[ff]) // RANK_MAX)) for ff in live))
