"""INT8/INT16 rank quantization of node tables — exact decision parity.

The north-star's "weight-only quantization of node tables": thresholds and
feature values are replaced by small integers while predictions stay
bit-identical to the float engine. The trick is that tree traversal never does
arithmetic on features — only ``x >= thresh`` comparisons (Struct.h:383) — so
any *order-preserving* remapping of (feature values, thresholds) preserves
every routing decision exactly:

  For each feature f, collect the sorted unique thresholds U_f used by any
  node splitting on f. Define
      rank_f(x)      = #{u in U_f : u <= x}     (searchsorted right)
      rank_f(theta)  = index of theta in U_f + 1
  Then  x >= theta  ⇔  rank_f(x) >= rank_f(theta),  exactly, for all finite
  x (ties included, because theta ∈ U_f).

Node tables shrink to int8 when every feature has ≤ 254 distinct thresholds
(hist-trained GBDTs: ≤ 256 bins) and int16 otherwise — the same adaptive-width
spirit as the reference's char/short/int fid packing (Struct.h:1827-1852).
Features are transformed once per batch (a fused searchsorted on device or
numpy on host); missing values keep their sentinel semantics by being mapped
to rank 0 with the routing handled by the engines' missing path (rank 0 is
below every threshold rank ≥ 1, so ``cond`` is False exactly like a NaN
compare — engines then apply def_right routing through their usual mask).
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from tahoe_tpu.config import MISSING_EPS
from tahoe_tpu.forest.spec import ForestSpec


@dataclasses.dataclass
class RankQuantizedForest:
    """ForestSpec with values replaced by threshold ranks (internal nodes).

    - ``spec`` — a ForestSpec whose internal-node ``values`` hold f32-encoded
      integer ranks (exact: ranks ≤ 2^24); leaf values stay true f32.
    - ``tables`` — per-feature sorted unique thresholds (for transforming x).
    - ``width`` — 1 (int8-representable ranks) or 2 (int16).
    """

    spec: ForestSpec
    tables: List[np.ndarray]
    width: int

    @property
    def max_ranks(self) -> int:
        return max((len(t) for t in self.tables), default=0)


def quantize(forest: ForestSpec) -> RankQuantizedForest:
    """Build the rank-domain forest (thresholds → ranks, exact).

    Threshold tables collect only REACHABLE internal nodes: complete-tree
    storage fills subtrees below early leaves with never-visited filler whose
    thresholds would otherwise inflate table sizes (and band counts). Filler
    nodes still get ranks assigned (clipped searchsorted against the real
    table) — they are never compared, any value is correct there."""
    from tahoe_tpu.forest.compiler import reachable_mask

    F = forest.num_cols
    internal = ~forest.is_leaf
    live = internal & reachable_mask(forest)
    tables: List[np.ndarray] = []
    for f in range(F):
        mask = live & (forest.fids == f)
        thr = np.unique(forest.values[mask]) if mask.any() else np.empty(0, np.float32)
        tables.append(thr.astype(np.float32))

    spec = forest.copy()
    for f in range(F):
        mask = internal & (forest.fids == f)
        if not mask.any():
            continue
        ranks = np.searchsorted(tables[f], forest.values[mask], side="right")
        # theta ∈ U_f ⇒ rank(theta) = index+1 = searchsorted right ✓
        spec.values[mask] = ranks.astype(np.float32)
    width = 1 if max((len(t) for t in tables), default=0) <= 254 else 2
    return RankQuantizedForest(spec=spec, tables=tables, width=width)


def band_split(q: RankQuantizedForest, band: int | None = None
               ) -> tuple[RankQuantizedForest, np.ndarray | None]:
    """Split features whose threshold count exceeds the plane encoding's rank
    cap into multiple *virtual features*, one per band of ``band`` sorted
    thresholds — the unlock for very deep / very large forests where a single
    feature accumulates >16255 distinct thresholds.

    Virtual feature (f, b) owns thresholds tables[f][b*band:(b+1)*band]; a
    node with global rank r on f maps to vfid (f, (r-1)//band) with local
    rank r - band*(r-1)//band ∈ [1, band]. The row-side transform needs no new
    math: searchsorted against the band's own table IS
    clip(rank_f(x) - b*band, 0, |band table|), which preserves every compare
    exactly (cond ⇔ rank_f(x) >= r: below-band ranks clip to 0 < local,
    above-band ranks clip to |table| >= local; both sides of the band bound
    are contradiction-free because ranks are monotone).

    Returns (q', base_map) where base_map[vf] = source feature column for
    row expansion, or (q, None) when no split is needed.
    """
    from tahoe_tpu.forest.compiler import RANK_MAX

    band = band or RANK_MAX
    if q.max_ranks <= band:
        return q, None

    new_tables: List[np.ndarray] = []
    base_map: List[int] = []
    first_vf = []  # feature f's first virtual feature index
    for f, t in enumerate(q.tables):
        first_vf.append(len(new_tables))
        nb = max(1, -(-len(t) // band))
        for b in range(nb):
            new_tables.append(t[b * band : (b + 1) * band])
            base_map.append(f)

    spec = q.spec.copy()
    internal = ~spec.is_leaf
    ranks = spec.values[internal].astype(np.int64)
    fids = spec.fids[internal]
    # pass-through internal nodes may carry rank 0 (no thresholds on the
    # feature) — band 0, local rank 0 keeps cond False for every x >= 1
    b_idx = np.maximum(ranks - 1, 0) // band
    spec.fids[internal] = np.asarray(first_vf, np.int32)[fids] + b_idx.astype(np.int32)
    spec.values[internal] = (ranks - b_idx * band).astype(np.float32)
    spec.num_cols = len(new_tables)
    return (
        RankQuantizedForest(spec=spec, tables=new_tables, width=q.width),
        np.asarray(base_map, np.int32),
    )


def transform_rows_np(q: RankQuantizedForest, data: np.ndarray) -> np.ndarray:
    """Features → ranks (f32-encoded ints; missing → NaN) on the host.

    Missing inputs (NaN or sentinel per the forest) become NaN so the engines'
    missing path fires exactly as in the float domain.
    """
    data = np.asarray(data, np.float32)
    missing = q.spec.missing
    if np.isnan(np.float32(missing)):
        miss = np.isnan(data)
    else:
        miss = np.abs(data - np.float32(missing)) <= np.float32(MISSING_EPS)
    out = np.empty_like(data)
    for f in range(data.shape[1]):
        out[:, f] = np.searchsorted(q.tables[f], data[:, f], side="right")
    out[miss] = np.nan
    # the engines' finite-sentinel detection must NOT re-fire on rank values:
    # ranks are >= 0, so any finite sentinel is safe once we use NaN here
    return out


def transform_rows_device(q: RankQuantizedForest, data):
    """Device-side rank transform: a binary search per (row, feature).

    rank_f(x) = #{u in U_f : u <= x} = searchsorted(U_f, x, side="right"),
    log2|U_f| steps per value instead of |U_f| compares. Tables are padded
    to the largest size with +inf (never <= a finite x). The search orders
    floats totally, so two IEEE cases are pinned to the compare semantics:
    -0.0 becomes +0.0 on both sides, and a NaN that is not the missing
    sentinel gets rank 0 (``NaN >= t`` is False for every threshold).
    """
    import jax
    import jax.numpy as jnp

    data = jnp.asarray(data, jnp.float32)
    missing = q.spec.missing
    if np.isnan(np.float32(missing)):
        miss = jnp.isnan(data)
    else:
        miss = jnp.abs(data - jnp.float32(missing)) <= jnp.float32(MISSING_EPS)

    kmax = max(q.max_ranks, 1)
    padded = np.full((len(q.tables), kmax), np.inf, np.float32)
    for f, t in enumerate(q.tables):
        padded[f, : len(t)] = np.where(t == 0, np.float32(0), t)
    x = jnp.where(data == 0, jnp.float32(0), data)
    ranks = jax.vmap(
        lambda u, col: jnp.searchsorted(u, col, side="right"),
        in_axes=(0, 1), out_axes=1,
    )(jnp.asarray(padded), x)
    ranks = jnp.where(jnp.isnan(x), 0, ranks).astype(jnp.float32)
    return jnp.where(miss, jnp.float32(np.nan), ranks)


def encode_rank_planes_np(ranks: np.ndarray) -> np.ndarray:
    """f32 rank rows (NaN = missing) → int8 plane vectors [R, 128*G].

    Lane map per compiler.rank_normalize: base-127 hi/lo planes, negated
    planes, and two constant lanes per 30-feature GROUP (constants live in
    group 0; other groups' constant lanes are unused by the matrices), so
    that one int8 matmul against the per-level matrices yields ``q - rank``
    (or its negated-class twin) per node. Missing rows get -128 in all four
    planes, which drives every class's diff negative (cond False → the
    pre-mirrored missing route)."""
    from tahoe_tpu.forest.compiler import (
        RANK_BASE, RANK_GROUP_COLS, RANK_LANE_C1, RANK_LANE_C127,
        RANK_LANE_NQH, RANK_LANE_NQL, RANK_LANE_QH, RANK_LANE_QL,
        RANK_MAX_COLS, rank_groups,
    )

    ranks = np.asarray(ranks)
    R, F = ranks.shape
    if F > RANK_MAX_COLS:
        raise ValueError(f"rank planes support <= {RANK_MAX_COLS} features")
    G = rank_groups(F)
    miss = np.isnan(ranks)
    q16 = np.where(miss, 0, ranks).astype(np.int64)
    qh = (q16 // RANK_BASE).astype(np.int8)
    ql = (q16 % RANK_BASE).astype(np.int8)
    out = np.zeros((R, 128 * G), np.int8)
    for g in range(G):
        f0 = g * RANK_GROUP_COLS
        w = min(RANK_GROUP_COLS, F - f0)
        b = 128 * g
        sl = slice(f0, f0 + w)
        out[:, b + RANK_LANE_QH : b + RANK_LANE_QH + w] = np.where(
            miss[:, sl], -128, qh[:, sl])
        out[:, b + RANK_LANE_QL : b + RANK_LANE_QL + w] = np.where(
            miss[:, sl], -128, ql[:, sl])
        out[:, b + RANK_LANE_NQH : b + RANK_LANE_NQH + w] = np.where(
            miss[:, sl], -128, -qh[:, sl])
        out[:, b + RANK_LANE_NQL : b + RANK_LANE_NQL + w] = np.where(
            miss[:, sl], -128, -ql[:, sl])
        out[:, b + RANK_LANE_C127] = 127
        out[:, b + RANK_LANE_C1] = 1
    return out


def encode_rank_planes_device(ranks):
    """Device-side twin of encode_rank_planes_np (jit-compatible)."""
    import jax.numpy as jnp

    from tahoe_tpu.forest.compiler import (
        RANK_BASE, RANK_GROUP_COLS, RANK_LANE_C1, RANK_LANE_C127,
        RANK_LANE_NQH, RANK_LANE_NQL, RANK_LANE_QH, RANK_LANE_QL,
        rank_groups,
    )

    R, F = ranks.shape
    G = rank_groups(F)
    miss = jnp.isnan(ranks)
    q16 = jnp.where(miss, 0, ranks).astype(jnp.int32)
    qh = q16 // RANK_BASE
    ql = q16 % RANK_BASE
    m128 = jnp.int32(-128)
    out = jnp.zeros((R, 128 * G), jnp.int32)
    for g in range(G):
        f0 = g * RANK_GROUP_COLS
        w = min(RANK_GROUP_COLS, F - f0)
        b = 128 * g
        sl = slice(f0, f0 + w)
        for lane, vals in (
            (RANK_LANE_QH, jnp.where(miss, m128, qh)),
            (RANK_LANE_QL, jnp.where(miss, m128, ql)),
            (RANK_LANE_NQH, jnp.where(miss, m128, -qh)),
            (RANK_LANE_NQL, jnp.where(miss, m128, -ql)),
        ):
            out = out.at[:, b + lane : b + lane + w].set(vals[:, sl])
        out = out.at[:, b + RANK_LANE_C127].set(127)
        out = out.at[:, b + RANK_LANE_C1].set(1)
    return out.astype(jnp.int8)


def quantized_spec_for_engines(q: RankQuantizedForest) -> ForestSpec:
    """The rank-domain ForestSpec ready for any engine: missing sentinel is
    forced to NaN (transform_rows_* emits NaN for missing)."""
    spec = q.spec.copy()
    spec.missing = float("nan")
    return spec
