"""Regressions for code-review findings (see commit history): edge cases
in layout compaction, grouped reductions, empty/explicit-dict encodes,
wide pad semantics."""

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu.util import GROUP


def test_bitmap_to_indices_trailing_zero_bits():
    import jax.numpy as jnp

    from giddy_tpu.layout import bitmap_to_indices

    idx, count = bitmap_to_indices(jnp.asarray(np.array([1, 0], np.uint32)), max_count=1)
    assert int(count) == 1 and int(idx[0]) == 0
    idx, count = bitmap_to_indices(
        jnp.asarray(np.array([1, 1, 0, 1, 0], np.uint32)), max_count=3
    )
    np.testing.assert_array_equal(np.asarray(idx), [0, 1, 3])


def test_group_reduce_unsigned_fill():
    from giddy_tpu.scan import group_reduce

    x = np.full(GROUP + 1, 5, np.uint32)
    np.testing.assert_array_equal(np.asarray(group_reduce(x, "max")), [5, 5])
    y = np.full(GROUP + 1, 2**31 + 7, np.uint64).astype(np.uint32)
    assert int(np.asarray(group_reduce(y, "min"))[1]) == 2**31 + 7


def test_bitmap_empty_column():
    col = gt.encode(np.array([], np.int32), "bitmap")
    assert col.params["d"] == 0
    assert gt.decode_ref(col).shape == (0,)
    assert np.asarray(gt.decode(col)).shape == (0,)


def test_dict_explicit_dictionary_missing_value():
    with pytest.raises(ValueError, match="missing"):
        gt.encode(np.array([1, 99], np.int32), "dict", dictionary=np.array([1, 2, 3], np.int32))


def test_wide_pad_flag():
    v = (np.arange(100, dtype=np.int64) + 10**15)
    col = gt.encode(v, "wide", base_scheme="nbit")
    assert gt.decode(col, pad=True).shape[0] == GROUP
    assert gt.decode(col).shape[0] == 100


def test_decode_columns_cached():
    from giddy_tpu.api import _COLUMNS_CACHE

    rng = np.random.default_rng(0)
    v = rng.integers(0, 100, GROUP).astype(np.int32)
    cols = [gt.encode(v, "nbit", name="a"), gt.encode(v + 1, "nbit", name="b")]
    before = len(_COLUMNS_CACHE)
    gt.decode_columns(cols)
    gt.decode_columns(cols)
    assert len(_COLUMNS_CACHE) == before + 1


def test_minmax_empty_column_raises():
    col = gt.encode(np.empty(0, np.int32), "nbit")
    from giddy_tpu.aggregate import max_, min_

    with pytest.raises(ValueError, match="empty"):
        min_(col)
    with pytest.raises(ValueError, match="empty"):
        max_(col)


def test_attach_valid_invalidates_device_cache():
    from giddy_tpu import nulls
    from giddy_tpu.query import count_where

    rng = np.random.default_rng(0)
    v = rng.integers(0, 100, GROUP).astype(np.int32)
    m1 = rng.random(GROUP) >= 0.5
    col = gt.encode(v, "nbit", valid=m1)
    assert count_where(col, "ge", 0) == int(m1.sum())
    m2 = rng.random(GROUP) >= 0.5
    nulls.attach_valid(col, m2)  # re-attach must drop the uploaded words
    assert count_where(col, "ge", 0) == int(m2.sum())


def test_isin_narrow_alias_consistent_across_set_sizes():
    """Values aliasing mod 2^32 onto a narrow dtype must not match in
    EITHER isin path (the <=8-value eq scans once disagreed with the
    searched path)."""
    from giddy_tpu.query import count_bits, isin_bitmap

    v = np.array([-5, 1, 2, 3] * 64, np.int8)
    col = gt.encode(v.astype(np.int32).astype(np.int8), "raw")
    # raw scheme needs int32? use the int8 dtype column via from_arrays style
    col = gt.encode(v, "nbit")
    alias = 2**32 - 5  # bit pattern of int32 -5; NOT an int8 value
    assert count_bits(isin_bitmap(col, [alias]), v.size) == 0
    big = [alias] + list(range(50, 59))  # >8 values: searched path
    assert count_bits(isin_bitmap(col, big), v.size) == 0
    assert count_bits(isin_bitmap(col, [-5]), v.size) == int((v == -5).sum())
    assert count_bits(isin_bitmap(col, [-5] + list(range(50, 59))), v.size) == int((v == -5).sum())


def test_group_reduce_multi_no_phantom_null_combos():
    from giddy_tpu.groupby import group_reduce_multi

    k1v = np.array([1, 1, 2, 2] * 32, np.int32)
    k2v = np.array([7, 8, 7, 8] * 32, np.int32)
    valid = np.ones(k1v.size, bool)
    valid[1] = False  # row (1, 8) exists ONLY at this null row
    k1v2 = k1v.copy()
    k1v2[1] = 2  # make the filled combo (2, 8) real elsewhere; the null
    # row's raw combo (2, 8) is fine, but mark k2 null at a row whose
    # combo (1, 7) is unique to it
    k2valid = np.ones(k2v.size, bool)
    kv = np.array([5, 6] * 64, np.int32)
    kv[0] = 99  # combo (99, 7) exists only at row 0, which we null out
    kvalid = np.ones(kv.size, bool)
    kvalid[0] = False
    ka = gt.encode(kv, "dict", valid=kvalid)
    kb = gt.encode(k2v, "dict")
    r = group_reduce_multi([ka, kb], aggs=("count",))
    keys = [tuple(int(x) for x in t) for t in r.keys]
    assert all(c > 0 for c in r.count), (keys, r.count)
    # the null-only combo must not appear at all
    assert not any(k[0] == 99 for k in keys), keys


def test_dist_args_cache_bounded_and_memoized():
    from giddy_tpu import dist_query
    from giddy_tpu.dist import default_mesh
    from giddy_tpu.dist_query import group_reduce_sharded

    mesh = default_mesh()
    rng = np.random.default_rng(1)
    keys = gt.encode(rng.integers(0, 8, 2 * GROUP).astype(np.int32), "dict")
    group_reduce_sharded(keys, mesh=mesh)
    size1 = len(dist_query._ARGS_CACHE)
    for _ in range(3):  # repeats must hit the memoized codes column
        group_reduce_sharded(keys, mesh=mesh)
    assert len(dist_query._ARGS_CACHE) == size1
    assert len(dist_query._ARGS_CACHE) <= dist_query._ARGS_CACHE_MAX


def test_rle_chain_hard_env_raised():
    """Dense runs (length 2: thousands of runs per group) decode through
    the per-group run-table search at its deepest: r_pad past 128, the
    old select-chain/128-lane-search ceiling, must stay exact."""
    v = (np.arange(3 * GROUP, dtype=np.int64) // 2).astype(np.int32) % 40000
    col = gt.encode(v, "rle")
    streams = gt.api.device_streams(col)
    assert streams["ends"].shape[-1] > 128, streams["ends"].shape
    np.testing.assert_array_equal(np.asarray(gt.decode(col)), v)


def test_rle_rank_stays_in_table():
    """The run-table search's invariant: every group's last run ends at
    the GROUP sentinel, so each element's rank indexes a real run."""
    import jax.numpy as jnp

    from giddy_tpu.kernels.rle import expand_runs

    ends = np.array([[5, GROUP, GROUP, GROUP, GROUP, GROUP, GROUP, GROUP]], np.int32)
    vals = np.array([[7, 9, 0, 0, 0, 0, 0, 0]], np.uint32)
    out = np.asarray(expand_runs(jnp.asarray(ends), jnp.asarray(vals)))
    np.testing.assert_array_equal(out[0, :5], 7)
    np.testing.assert_array_equal(out[0, 5:], 9)


def test_model_extreme_span_ascending_frame():
    """ADVICE r4: an ascending frame whose true span exceeds 2^31 must not
    be misread as descending by the signed-window endpoint slope — the
    per-frame dual (signed/unsigned) reading keeps the narrower residual."""
    n = GROUP
    v = (np.arange(n, dtype=np.int64) * ((2**31 + 2**30) // n)).astype(np.uint32).view(np.int32)
    col = gt.encode(v, "model")
    np.testing.assert_array_equal(np.asarray(gt.decode(col)).view(np.int32), v)
    assert col.params["bits"] <= 18, col.params  # round-4 code packed ~32


def test_dzbv_tile_layout_full_tile_rank_clamp():
    """A plane that every element but a few selects: the unselected
    elements after the last selected one carry rank == plane length, one
    past the plane's end; their (discarded) gather index must be clamped,
    and the decode stay exact."""
    v = np.full(2 * GROUP, 300, np.uint32)  # all 2-byte: plane1 nearly full
    v[::7] = 5
    v[-3:] = 5
    col = gt.encode(v.view(np.int32), "dzbv")
    np.testing.assert_array_equal(np.asarray(gt.decode(col)).view(np.uint32), v)
