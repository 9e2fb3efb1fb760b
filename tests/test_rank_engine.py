"""int8 rank path in plain XLA (ops/rank_engine.py) vs the float oracle.

The rank path is exact integer arithmetic (int8 planes x int8 matrices,
int32 sums), so every routing decision equals the oracle's; only the f32
association of the leaf sum differs — 1e-5 at these sizes (the reference's
contract is 1e-3, cuda_base.h:103).
"""
import numpy as np
import pytest

from tahoe_tpu.config import Output
from tahoe_tpu.forest import compiler, quantize, synthetic
from tahoe_tpu.forest.train import train_forest
from tahoe_tpu.ops import oracle
from tahoe_tpu.ops.rank_engine import RankEngine, plan_chunks


def _check(forest, data, atol=1e-5, **kw):
    eng = RankEngine(forest, **kw)
    np.testing.assert_allclose(
        np.asarray(eng.predict(data)), oracle.predict(forest, data), atol=atol
    )
    return eng


@pytest.mark.parametrize("depth,trees,cols,leaf_prob", [
    (1, 5, 3, 0.0),
    (4, 17, 9, 0.2),
    (5, 70, 20, 0.15),
    (0, 3, 2, 0.0),      # a forest of stumps
])
def test_matches_oracle(depth, trees, cols, leaf_prob):
    forest = synthetic.generate_forest(trees, depth, cols, leaf_prob=leaf_prob,
                                       seed=depth + 140)
    data = synthetic.generate_data(37, cols, missing_prob=0.1, seed=depth + 240)
    _check(forest, data)


@pytest.mark.parametrize("missing", [float("nan"), -999.0, 0.0])
def test_missing_sentinels(missing):
    forest = synthetic.generate_forest(11, 4, 5, missing=missing,
                                       leaf_prob=0.1, seed=153)
    data = synthetic.generate_data(45, 5, missing=missing, missing_prob=0.25,
                                   seed=154)
    _check(forest, data)


def test_threshold_ties_exact():
    forest = synthetic.generate_forest(9, 4, 6, seed=151)
    data = synthetic.generate_data(40, 6, seed=152)
    data[0, :] = forest.values[0, :6]  # exact threshold hits
    _check(forest, data)


def test_signed_zero_and_infinities():
    """The device transform's binary search orders floats totally; -0.0,
    +-inf and ties must still route like the IEEE compares."""
    forest = synthetic.generate_forest(20, 4, 4, seed=155)
    forest.values[:, :3] = [0.0, -0.0, 0.0]
    data = synthetic.generate_data(16, 4, seed=156)
    data[0, :] = [-0.0, 0.0, np.inf, -np.inf]
    data[1, :] = [0.0, -0.0, -np.inf, np.inf]
    _check(forest, data)


@pytest.mark.parametrize("leaf_prob", [0.0, 0.2, 0.4])
def test_hot_swapped_forest(leaf_prob):
    """Exchange bits and early leaves survive the rank-domain normalization."""
    forest = compiler.hot_child_swap(
        synthetic.generate_forest(8, 5, 10, leaf_prob=leaf_prob, seed=155)
    )
    data = synthetic.generate_data(30, 10, missing_prob=0.15, seed=156)
    _check(forest, data)


@pytest.mark.parametrize("output", [
    Output.AVG, Output.AVG | Output.SIGMOID,
    Output.AVG | Output.SIGMOID | Output.THRESHOLD,
])
def test_output_transforms(output):
    forest = synthetic.generate_forest(13, 4, 7, output=int(output),
                                       global_bias=0.25, missing=-999.0,
                                       seed=157)
    data = synthetic.generate_data(50, 7, missing=-999.0, missing_prob=0.1,
                                   seed=158)
    _check(forest, data)


@pytest.mark.parametrize("cols,min_groups", [
    (54, 2),     # two plane groups
    (126, 5),    # 121-128 features: the last group reaches past lane 128
    (150, 5),
    (480, 16),   # the plane-group cap
])
def test_wide_multi_group(cols, min_groups):
    forest = synthetic.generate_forest(40, 5, cols, leaf_prob=0.05, seed=162)
    data = synthetic.generate_data(24, cols, missing_prob=0.1, seed=163)
    eng = _check(forest, data)
    assert eng.groups >= min(min_groups,
                             -(-eng.num_cols // compiler.RANK_GROUP_COLS))


def test_too_many_features_rejected():
    forest = synthetic.generate_forest(900, 4, 700, seed=159)
    assert np.unique(forest.fids[~forest.is_leaf]).size > 480
    with pytest.raises(NotImplementedError):
        RankEngine(forest)


@pytest.mark.parametrize("depth,trees,cols,band", [
    (5, 30, 6, 37),
    (6, 40, 10, 64),
    (4, 12, 3, 16),     # heavy banding: ~3 bands per feature
])
def test_band_split_matches_oracle(depth, trees, cols, band):
    """Features over the rank cap split into banded virtual features
    (quantize.band_split) with exact compare parity."""
    forest = synthetic.generate_forest(trees, depth, cols, leaf_prob=0.1,
                                       seed=depth * 11 + trees)
    data = synthetic.generate_data(71, cols, missing_prob=0.15, seed=5)
    eng = _check(forest, data, band=band)
    assert eng.col_gather is not None


def test_band_split_finite_missing():
    forest = synthetic.generate_forest(20, 5, 6, leaf_prob=0.1, missing=-999.0,
                                       seed=77)
    data = synthetic.generate_data(64, 6, missing_prob=0.2, missing=-999.0,
                                   seed=9)
    eng = _check(forest, data, band=23)
    assert eng.col_gather is not None


def test_band_split_noop_when_under_cap():
    forest = synthetic.generate_forest(6, 4, 5, seed=80)
    q = quantize.quantize(forest)
    q2, base = quantize.band_split(q)
    assert base is None and q2 is q


@pytest.mark.parametrize("depth,trees", [(12, 6), (13, 4)])
def test_deep_dense(depth, trees):
    forest = synthetic.generate_forest(trees, depth, 10, leaf_prob=0.05,
                                       seed=depth)
    data = synthetic.generate_data(9, 10, missing_prob=0.1, seed=164)
    _check(forest, data)


def test_deep18_trained():
    """A depth-18 trained ensemble: the matrices cover the complete trees,
    chunked one tree at a time under the block budget."""
    forest = train_forest(3, 18, 8, rows=256, seed=3)
    data = synthetic.generate_data(12, 8, missing_prob=0.02, seed=4)
    _check(forest, data, atol=1e-4)


@pytest.mark.parametrize("chunk_elems,tree_chunk", [
    (1 << 8, None),     # several row chunks and one tree per chunk
    (1 << 12, 4),       # several tree chunks with padding trees
    (1 << 26, None),    # one chunk of each
])
def test_chunking_is_exact(chunk_elems, tree_chunk, monkeypatch):
    from tahoe_tpu.ops import rank_engine

    monkeypatch.setattr(rank_engine, "CHUNK_ELEMS", chunk_elems)
    forest = synthetic.generate_forest(30, 5, 8, leaf_prob=0.1, seed=60)
    data = synthetic.generate_data(70, 8, missing_prob=0.1, seed=61)
    eng = _check(forest, data, tree_chunk=tree_chunk)
    cfg = eng.config(70)
    assert cfg.row_chunk * cfg.tree_chunk * 16 <= max(chunk_elems, 16)


@pytest.mark.parametrize("trees,depth,rows,want", [
    (500, 8, 65536, (128, 4096)),    # SUSY class: 16 row x 4 tree chunks
    (30, 15, 1000, (16, 256)),       # deep: 256-row chunks, fewer trees
    (5, 3, 10, (8, 16)),             # tiny: one chunk covers everything
])
def test_plan_chunks(trees, depth, rows, want):
    assert plan_chunks(trees, depth, rows) == want


def test_plane_encoding_round_trip():
    import jax.numpy as jnp

    forest = synthetic.generate_forest(5, 3, 4, seed=157)
    data = synthetic.generate_data(25, 4, missing_prob=0.2, seed=158)
    q = quantize.quantize(forest)
    host = quantize.encode_rank_planes_np(quantize.transform_rows_np(q, data))
    dev = np.asarray(quantize.encode_rank_planes_device(
        quantize.transform_rows_device(q, jnp.asarray(data))))
    np.testing.assert_array_equal(host, dev)
