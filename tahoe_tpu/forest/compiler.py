"""Forest compiler: structure-aware optimization passes.

The re-design of ``dense_adaptive_forest::init``'s host-side model
compilation pipeline (Struct.h:1756-1986): decode → hot-child swap with
exchange bits → adaptive fid-width selection → similar-tree clustering →
packed encode → tree-major and node-major layouts. Every pass here is a pure
``ForestSpec → ForestSpec`` (or derived-form) array transformation, vectorized
over numpy, and each is verified semantics-preserving by oracle parity tests.

Two passes intentionally diverge from the reference:

- **simhash clustering** hashes each tree's actual content tokens. The
  reference feeds *uninitialized* buffers to its simhash (Struct.h:1854-1870),
  so its published clustering sorts garbage; the intended capability —
  placing structurally similar trees on adjacent lanes so vectorized descent
  takes similar paths — is implemented properly here.
- **levelize** produces the representation none of the reference kernels have:
  per-level node tables in *bit-reversed node order* with early leaves pushed
  to the bottom and exchange bits folded in. Bit reversal makes the
  select-fold recurrence read contiguous halves instead of even/odd
  interleaves (see LeveledForest and tensor_engine), and turns a descent step
  into ``p += cond << d`` (ops/fold_kernel.py).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from tahoe_tpu.config import (
    NodeWidth,
    def_left_mask,
    exchange_mask,
    fid_mask,
    is_leaf_mask,
)
from tahoe_tpu.forest.spec import ForestSpec, LeveledForest, PackedForest
from tahoe_tpu.forest.simhash import tree_simhash_order


# ----------------------------------------------------------------------
# Pass 1: hot-child swapping
# ----------------------------------------------------------------------

def hot_child_swap(forest: ForestSpec) -> ForestSpec:
    """Reorder each split's children so the higher-training-weight child is on
    the right, recording an ``exchange`` bit on the parent.

    Semantics-preserving: traversal inverts the branch condition at exchanged
    nodes (Struct.h:896-898), so predictions are bit-identical; what changes is
    which side the "hot" (more probable) subtree lives on, which the reference
    exploits for branch coherence (Struct.h:1775-1825) and which here gives
    the select-fold a statistically warmer second half.

    Vectorized form of the reference's per-node loops: levels are processed
    bottom-up; a swap at level d mirrors the two child subtrees at every level
    below via a reshape into [T, 2^d, 2, subtree] blocks.
    """
    out = forest.copy()
    depth = forest.depth
    arrays = (out.values, out.weights, out.fids, out.def_left, out.is_leaf, out.exchange)

    for d in range(depth - 1, -1, -1):
        lev = out.level_slice(d)
        child = out.level_slice(d + 1)
        # children of node o at level d sit at (2o, 2o+1) within level d+1
        cw = out.weights[:, child].reshape(forest.num_trees, 1 << d, 2)
        swap = (~out.is_leaf[:, lev]) & (cw[:, :, 0] < cw[:, :, 1])

        out.exchange[:, lev] |= swap

        for dd in range(d + 1, depth + 1):
            lev_dd = out.level_slice(dd)
            sub = 1 << (dd - d - 1)
            for arr in arrays:
                block = arr[:, lev_dd].reshape(forest.num_trees, 1 << d, 2, sub)
                mirrored = block[:, :, ::-1, :]
                sel = np.where(swap[:, :, None, None], mirrored, block)
                arr[:, lev_dd] = sel.reshape(forest.num_trees, 1 << dd)
    return out


# ----------------------------------------------------------------------
# Pass 2: adaptive node-metadata width
# ----------------------------------------------------------------------

def select_width(forest: ForestSpec) -> NodeWidth:
    """Narrowest packing whose fid field holds the forest's max feature id
    (reference: Struct.h:1827-1852)."""
    return NodeWidth.for_max_fid(forest.max_fid)


# ----------------------------------------------------------------------
# Pass 3: similar-tree clustering
# ----------------------------------------------------------------------

def cluster_trees(forest: ForestSpec) -> Tuple[ForestSpec, np.ndarray]:
    """Reorder trees so structurally similar trees are adjacent.

    Returns (reordered forest, permutation) with perm[i] = original index of
    the tree now at slot i. Tree order does not affect predictions (margins
    are a sum over trees), only memory/lane locality.
    """
    order = tree_simhash_order(forest)
    out = forest.copy()
    for name in ("values", "weights", "fids", "def_left", "is_leaf", "exchange"):
        arr = getattr(forest, name)
        getattr(out, name)[:] = arr[order]
    return out, order


# ----------------------------------------------------------------------
# Pass 4: packed adaptive encode (tree-major + node-major layouts)
# ----------------------------------------------------------------------

_WIDTH_DTYPE = {NodeWidth.CHAR: np.uint8, NodeWidth.SHORT: np.uint16, NodeWidth.INT: np.uint32}


def pack(forest: ForestSpec, width: NodeWidth | None = None) -> PackedForest:
    """Pack {fid, def_left, is_leaf, exchange} into an adaptive-width integer
    table parallel to the f32 values table, in both layouts
    (reference encode: Struct.h:77-98; layouts: Struct.h:1893-1923)."""
    if width is None:
        width = select_width(forest)
    dt = _WIDTH_DTYPE[width]
    bits = (
        (forest.fids.astype(np.int64) & fid_mask(width))
        | (forest.def_left.astype(np.int64) * def_left_mask(width))
        | (forest.is_leaf.astype(np.int64) * is_leaf_mask(width))
        | (forest.exchange.astype(np.int64) * exchange_mask(width))
    ).astype(dt)
    return PackedForest(
        depth=forest.depth,
        num_cols=forest.num_cols,
        width_bytes=int(width),
        values=forest.values.copy(),
        bits=bits,
        values_reorg=np.ascontiguousarray(forest.values.T),
        bits_reorg=np.ascontiguousarray(bits.T),
        tree_order=np.arange(forest.num_trees, dtype=np.int32),
        output=forest.output,
        global_bias=forest.global_bias,
        threshold=forest.threshold,
        missing=forest.missing,
    )


def unpack(packed: PackedForest) -> ForestSpec:
    """Inverse of :func:`pack` (weights are not preserved — they only feed the
    hot-swap pass, like the reference's encode which drops them too,
    Struct.h:77-98)."""
    width = NodeWidth(packed.width_bytes)
    b = packed.bits.astype(np.int64)
    return ForestSpec(
        depth=packed.depth,
        num_cols=packed.num_cols,
        values=packed.values.copy(),
        weights=np.zeros_like(packed.values),
        fids=(b & fid_mask(width)).astype(np.int32),
        def_left=(b & def_left_mask(width)) != 0,
        is_leaf=(b & is_leaf_mask(width)) != 0,
        exchange=(b & exchange_mask(width)) != 0,
        output=packed.output,
        global_bias=packed.global_bias,
        threshold=packed.threshold,
        missing=packed.missing,
    )


# ----------------------------------------------------------------------
# Pass 5: levelization (perfect-tree normalization, bit-reversed order)
# ----------------------------------------------------------------------

def bit_reverse_permutation(d: int) -> np.ndarray:
    """perm[j] = d-bit reversal of j (identity for d <= 1 entries)."""
    n = 1 << d
    perm = np.zeros(n, dtype=np.int64)
    for j in range(n):
        r = 0
        x = j
        for _ in range(d):
            r = (r << 1) | (x & 1)
            x >>= 1
        perm[j] = r
    return perm


def reachable_mask(forest: ForestSpec) -> np.ndarray:
    """[T, nodes] bool: node positions a traversal can actually reach (no
    ancestor is a leaf). Complete-tree storage fills subtrees below early
    leaves with never-visited filler nodes."""
    out = np.zeros_like(forest.is_leaf)
    reach = np.ones((forest.num_trees, 1), bool)
    for d in range(forest.depth + 1):
        lev = forest.level_slice(d)
        out[:, lev] = reach
        if d < forest.depth:
            reach = np.repeat(reach & ~forest.is_leaf[:, lev], 2, axis=1)
    return out


def reachable_depths(forest: ForestSpec) -> np.ndarray:
    """Per-tree effective depth: the number of select levels a traversal can
    actually take = 1 + depth of the deepest REACHABLE internal node (0 for a
    stump). Trained forests are stored as complete trees (the reference
    materializes 2^(depth+1)-1 nodes per tree, BaseTahoeTest.h:282-331), so
    trees whose real leaves sit high carry levels of unreachable filler that
    every dense engine would otherwise evaluate."""
    T = forest.num_trees
    depths = np.zeros(T, np.int32)
    reach = np.ones((T, 1), bool)
    for d in range(forest.depth):
        internal = reach & ~forest.is_leaf[:, forest.level_slice(d)]
        depths[internal.any(axis=1)] = d + 1
        reach = np.repeat(internal, 2, axis=1)
    return depths


def truncate_depth(forest: ForestSpec, new_depth: int) -> ForestSpec:
    """Complete-tree prefix slice to ``new_depth`` levels. EXACT whenever
    ``new_depth >= reachable_depths(forest).max()``: every node at the new
    leaf level is then a real leaf or unreachable filler, so the level's
    values are valid leaf values wherever a traversal can land."""
    from tahoe_tpu.config import tree_num_nodes

    if new_depth >= forest.depth:
        return forest
    n = tree_num_nodes(new_depth)
    out = forest.copy()
    out.depth = new_depth
    out.values = np.ascontiguousarray(forest.values[:, :n])
    out.weights = np.ascontiguousarray(forest.weights[:, :n])
    out.fids = np.ascontiguousarray(forest.fids[:, :n])
    out.def_left = np.ascontiguousarray(forest.def_left[:, :n])
    out.is_leaf = forest.is_leaf[:, :n].copy()
    out.exchange = np.ascontiguousarray(forest.exchange[:, :n])
    out.is_leaf[:, out.level_slice(new_depth)] = True
    return out


def levelize(forest: ForestSpec, *, truncate: bool = True) -> LeveledForest:
    """ForestSpec → LeveledForest: the engine-facing derived form.

    Three normalizations, all semantics-preserving:

    1. **Early-leaf push-down**: a leaf above max depth becomes an
       "always-left" pass-through (thresh=+inf, def routes left) and its value
       is copied into both children, recursively — so every path has length
       exactly ``depth`` and engines run unconditional select steps with no
       is_leaf masking (the reference instead carries an active-lane mask
       through every kernel, e.g. Struct.h:363-377).
    2. **Exchange folding**: effective condition at a node is
       ``miss ? (!def_left XOR exchange) : ((x >= thresh) XOR exchange)``
       (Struct.h:894-898); we precompute ``def_right = !def_left XOR exchange``
       and ``invert = exchange`` so traversal needs no exchange decode.
    3. **Bit-reversed node order** within each level: node with path bits
       (b_0..b_{d-1}) (b_0 = root decision) is stored at index
       Σ b_k << k instead of Σ b_k << (d-1-k). Under this order the fold
       recurrence becomes
       ``w_d[j] = cond_d[j] ? w_{d+1}[j + 2^d] : w_{d+1}[j]`` —
       contiguous-half selects with no even/odd deinterleave.

    Plus one work-saving rewrite (``truncate=True``): levels deeper than any
    REACHABLE internal node are dropped before push-down (truncate_depth) —
    trained forests stored as complete trees carry unreachable filler levels
    that would otherwise cost every dense engine 2^d selects each.
    """
    if truncate:
        d_eff = int(reachable_depths(forest).max(initial=0))
        if d_eff < forest.depth:
            forest = truncate_depth(forest, d_eff)
    T, depth = forest.num_trees, forest.depth

    values = forest.values.copy()
    fids = forest.fids.copy()
    def_left = forest.def_left.copy()
    is_leaf = forest.is_leaf.copy()
    exchange = forest.exchange.copy()

    # 1. push early leaves down, level by level, top-down
    for d in range(depth):
        lev = forest.level_slice(d)
        child = forest.level_slice(d + 1)
        leaf_here = is_leaf[:, lev]  # [T, 2^d]
        if leaf_here.any():
            leaf_vals = values[:, lev]
            cv = values[:, child].reshape(T, 1 << d, 2)
            cl = is_leaf[:, child].reshape(T, 1 << d, 2)
            mask = leaf_here[:, :, None]
            np.copyto(cv, np.broadcast_to(leaf_vals[:, :, None], cv.shape), where=mask)
            np.copyto(cl, True, where=mask)
            values[:, child] = cv.reshape(T, 1 << (d + 1))
            is_leaf[:, child] = cl.reshape(T, 1 << (d + 1))
            # the node itself becomes an always-left pass-through. NaN as the
            # threshold makes `x >= thresh` False for EVERY x (±inf included),
            # which is exactly "route left unconditionally".
            values[:, lev] = np.where(leaf_here, np.float32(np.nan), values[:, lev])
            fids[:, lev] = np.where(leaf_here, 0, fids[:, lev])
            # and missing routes !def_left = left when def_left=True
            def_left[:, lev] = np.where(leaf_here, True, def_left[:, lev])
            exchange[:, lev] = np.where(leaf_here, False, exchange[:, lev])

    # 2+3. fold exchange, apply bit-reversed order per level
    thresh_l, fid_l, def_right_l, invert_l = [], [], [], []
    for d in range(depth):
        lev = forest.level_slice(d)
        perm = bit_reverse_permutation(d)
        thresh_l.append(values[:, lev][:, perm])
        fid_l.append(fids[:, lev][:, perm])
        dr = (~def_left[:, lev]) ^ exchange[:, lev]
        def_right_l.append(dr[:, perm])
        invert_l.append(exchange[:, lev][:, perm])

    leaf_perm = bit_reverse_permutation(depth)
    leaf_values = values[:, forest.level_slice(depth)][:, leaf_perm]

    return LeveledForest(
        depth=depth,
        num_cols=forest.num_cols,
        thresh=thresh_l,
        fid=fid_l,
        def_right=def_right_l,
        invert=invert_l,
        leaf_values=np.ascontiguousarray(leaf_values),
        output=forest.output,
        global_bias=forest.global_bias,
        threshold=forest.threshold,
        missing=forest.missing,
    )


# ----------------------------------------------------------------------
# Pass 5b: used-feature compaction
# ----------------------------------------------------------------------

def used_features(forest: ForestSpec) -> np.ndarray:
    """Sorted distinct feature ids referenced by REACHABLE internal nodes.

    Trained forests on wide datasets (gisette-class: thousands of columns)
    reference only the informative subset; everything else is dead weight the
    reference's kernels carry in every cached row (Struct.h:416-423). Engines
    use this to remap live fids into a compact range and gather only the live
    data columns — exact, because a forest's predictions depend only on the
    columns its reachable internal nodes compare."""
    m = reachable_mask(forest) & ~forest.is_leaf
    if not m.any():
        return np.zeros(0, np.int32)
    return np.unique(forest.fids[m]).astype(np.int32)


def compact_features(forest: ForestSpec):
    """ForestSpec → (compacted ForestSpec, col_index | None).

    Remaps live fids to [0, n_used); ``col_index`` maps compact column →
    original data column (callers gather rows as ``x[:, col_index]``).
    Returns (forest, None) unchanged when every column is used. Unreachable /
    leaf fid slots remap to 0 (their compares never influence a prediction —
    the fold's ancestor selects discard them)."""
    used = used_features(forest)
    if used.size >= forest.num_cols:
        return forest, None
    if used.size == 0:
        used = np.zeros(1, np.int32)  # num_cols must stay positive
    remap = np.zeros(forest.num_cols, np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    out = forest.copy()
    out.num_cols = int(used.size)
    out.fids = remap[forest.fids]
    return out, used


def compact_leveled(lev: LeveledForest):
    """LeveledForest → (compacted LeveledForest, col_index | None).

    Same rewrite at the derived-form level (levelize zeroes the fids of
    pass-through nodes, so every fid present in the level tables is live)."""
    import dataclasses

    if lev.depth == 0 or not lev.fid:
        return lev, None
    used = np.unique(np.concatenate([f.ravel() for f in lev.fid]))
    used = used.astype(np.int32)
    if used.size >= lev.num_cols:
        return lev, None
    remap = np.zeros(lev.num_cols, np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    out = dataclasses.replace(
        lev, num_cols=int(used.size), fid=[remap[f] for f in lev.fid]
    )
    return out, used


# ----------------------------------------------------------------------
# Pass 6: ge-normalization (single-compare form)
# ----------------------------------------------------------------------

def ge_normalize(lev: LeveledForest):
    """LeveledForest → single-compare form: every node's routing becomes
    ``ge(x'[fid'], t')`` with NO def_right/invert decode at runtime.

    The effective condition is ``miss ? def_right : (x >= t) ^ invert``
    (Struct.h:380-403, 894-898). Each of the four (def_right, invert) classes
    reduces to one IEEE >= compare through two compile-time rewrites:

    - **negated-feature lane** (when def_right ^ invert): rows carry [x, -x];
      ``x < t  ⇔  -x >= nextafter(-t, +inf)`` exactly (f32 is discrete), and
      NaN fails both lanes' compares;
    - **subtree mirror** (when def_right): swap the node's child subtrees at
      compile time so the compare's False branch is the missing route. In
      bit-reversed coordinates a mirror at (d, p) is just
      ``perm[d+1][p + b*2^d] = perm[d][p] + (b ^ 1)*2^d`` — position-bit
      flips, composed level by level.

    Class table (neg = use -x lane + nextafter threshold, swap = mirror):
      (dr=0, inv=0): plain ge            (dr=0, inv=1): neg
      (dr=1, inv=0): neg + swap          (dr=1, inv=1): swap

    Returns (fid_levels, thresh_levels, leaf_values): fid entries >= num_cols
    select the negated lane (fid' = fid + num_cols): rows carry 2F
    features.
    """
    fid_out, thr_out = [], []

    def visit(thr, fid, neg):
        F = lev.num_cols
        with np.errstate(invalid="ignore"):
            t_neg = np.nextafter(-thr, np.float32(np.inf)).astype(np.float32)
        thr_out.append(np.where(neg, t_neg, thr).astype(np.float32))
        fid_out.append(np.where(neg, fid + F, fid).astype(np.int32))

    leaf = _normalize_walk(lev, visit)
    return fid_out, thr_out, leaf


def _normalize_walk(lev: LeveledForest, visit):
    """Shared ge-normalization walk: per level, gathers node data at the
    mirror-composed positions, computes neg = def_right ^ invert, calls
    ``visit(thresh, fid, neg)`` to emit the level's tables, and propagates the
    subtree-mirror permutation (swap at def_right nodes). Returns the
    permuted leaf values [T, 2^D] f32."""
    T, D = lev.num_trees, lev.depth
    perm = np.zeros((T, 1), dtype=np.int64)
    for d in range(D):
        thr = np.take_along_axis(lev.thresh[d], perm, axis=1)
        fid = np.take_along_axis(lev.fid[d], perm, axis=1)
        dr = np.take_along_axis(lev.def_right[d], perm, axis=1)
        inv = np.take_along_axis(lev.invert[d], perm, axis=1)
        visit(thr, fid, dr ^ inv)
        swap = dr.astype(np.int64)
        new_perm = np.empty((T, 1 << (d + 1)), dtype=np.int64)
        new_perm[:, : 1 << d] = perm + swap * (1 << d)
        new_perm[:, 1 << d :] = perm + (1 - swap) * (1 << d)
        perm = new_perm
    leaf = np.take_along_axis(lev.leaf_values, perm, axis=1)
    return np.ascontiguousarray(leaf.astype(np.float32))


# ----------------------------------------------------------------------
# Pass 7: rank normalization (int8 matrix form)
# ----------------------------------------------------------------------

# Lane map for the rank-plane vector (see ops/rank_engine.py): base-127
# two-plane encoding q16 = 127*qh + ql with positive and negated planes plus
# two constant lanes, all within one 128-lane GROUP — 30 features per group.
# Forests with more features use G = ceil(F/30) groups (plane vector [G*128]
# lanes, matrices [G*128, cols]; one product with a G*128 contraction); the
# rank constants are written into group 0's constant lanes (every group's
# plane vector carries 127/1 there, so the layout is per-group
# self-contained). Ranks <= 16255.
#
# Group budget: the contraction (and so the traversal's matrix work and
# bytes) scales LINEARLY with G — each node's column is one-hot in its
# feature's group. The cap of 16 groups covers the widest reference dataset
# shapes (mnist-class trained forests use ~400 features → G = 14); the perf
# model charges G per node column.
RANK_BASE = 127
RANK_MAX = RANK_BASE * 127 + (RANK_BASE - 1)  # 16255
RANK_LANE_QH = 0
RANK_LANE_QL = 30
RANK_LANE_NQH = 60
RANK_LANE_NQL = 90
RANK_LANE_C127 = 120   # lhs carries constant 127 here
RANK_LANE_C1 = 121     # lhs carries constant 1 here
RANK_GROUP_COLS = 30
RANK_MAX_GROUPS = 16
RANK_MAX_COLS = RANK_GROUP_COLS * RANK_MAX_GROUPS  # 480


def rank_groups(num_cols: int) -> int:
    """Plane-vector groups needed for a feature count (1 group = 128 lanes)."""
    return max(1, -(-num_cols // RANK_GROUP_COLS))


def rank_normalize(lev_rank: LeveledForest):
    """Rank-domain LeveledForest → per-level int8 matrices.

    ``lev_rank`` is levelize() of a rank-quantized spec
    (quantize.quantized_spec_for_engines): internal thresholds hold integer
    ranks as f32 (pass-through nodes hold NaN). Produces per level an int8
    matrix R_d [128, T*2^d] such that for the encoded row-plane vector p
    (quantize.encode_rank_planes),

        diff[n] = p . R_d[:, n] = (q16[fid_n] - rank_n)        pos classes
                                  (-q16[fid_n] + rank_n - 1)   neg classes
                                  (-1)                          pass-through

    and the branch condition is exactly ``diff >= 0`` — the whole per-node
    rule (missing + def_left + exchange + compare, Struct.h:380-403/894-898)
    compiled into one int8 matmul column. Subtree mirrors (def_right) are
    composed into the node order exactly as in ge_normalize.

    Returns (mats [list of int8 [128, T*2^d]], leaf_values f32 [T, 2^D]).
    """
    F = lev_rank.num_cols
    if F > RANK_MAX_COLS:
        raise ValueError(f"rank form supports <= {RANK_MAX_COLS} features")
    G = rank_groups(F)
    mats = []

    def visit(thr, fid, neg):
        T, n = thr.shape
        m = np.zeros((128 * G, T * n), dtype=np.int8)
        cols = np.arange(T * n)
        rank = thr.reshape(-1)
        fidf = fid.reshape(-1)
        negf = neg.reshape(-1)
        passthrough = np.isnan(rank)
        r16 = np.where(passthrough, 0, rank).astype(np.int64)
        if (r16 < 0).any() or (r16 > RANK_MAX).any():
            raise ValueError(f"rank out of range for the int8 form (max {RANK_MAX})")
        rh = (r16 // RANK_BASE).astype(np.int8)
        rl = (r16 % RANK_BASE).astype(np.int8)

        # feature f lives in group f//30 at lane offset f%30
        grp = 128 * (fidf // RANK_GROUP_COLS)
        off = fidf % RANK_GROUP_COLS

        pos = ~passthrough & ~negf
        ng = ~passthrough & negf
        m[grp[pos] + RANK_LANE_QH + off[pos], cols[pos]] = RANK_BASE
        m[grp[pos] + RANK_LANE_QL + off[pos], cols[pos]] = 1
        m[RANK_LANE_C127, cols[pos]] = -rh[pos]
        m[RANK_LANE_C1, cols[pos]] = -rl[pos]
        m[grp[ng] + RANK_LANE_NQH + off[ng], cols[ng]] = RANK_BASE
        m[grp[ng] + RANK_LANE_NQL + off[ng], cols[ng]] = 1
        m[RANK_LANE_C127, cols[ng]] = rh[ng]
        m[RANK_LANE_C1, cols[ng]] = rl[ng] - 1
        m[RANK_LANE_C1, cols[passthrough]] = -1
        # column-major per (tree, node): reshape to [128G, T, n]
        mats.append(m.reshape(128 * G, T, n))

    leaf = _normalize_walk(lev_rank, visit)
    return mats, leaf


# ----------------------------------------------------------------------
# Full pipeline
# ----------------------------------------------------------------------

def compile_forest(forest: ForestSpec, *, swap: bool = True, cluster: bool = True):
    """The standard pipeline: hot-swap → cluster → (leveled, packed).

    Returns (compiled ForestSpec, LeveledForest, PackedForest, tree_order).
    """
    fc = hot_child_swap(forest) if swap else forest.copy()
    if cluster:
        fc, order = cluster_trees(fc)
    else:
        order = np.arange(fc.num_trees, dtype=np.int32)
    packed = pack(fc)
    packed.tree_order = order.astype(np.int32)
    return fc, levelize(fc), packed, order
