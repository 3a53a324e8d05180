"""Float columns: lossless bitpattern encode/decode + total-order predicates.

Floats ride as IEEE-754 bitpatterns through the uint32 payload path
(util._DTYPES); float64 splits into planes via the wide wrapper. Decode
must be bit-exact including NaN payloads and -0.0.
"""

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu.partial import decode_groups, take
from giddy_tpu.query import count_where, where_mask
from giddy_tpu.util import GROUP


def _f32_column(rng, n):
    v = (rng.normal(0, 100, n)).astype(np.float32)
    v[:6] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-38]
    return v


SCHEMES = ["raw", "nbit", "dict", "rle", "dzbv", "delta"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_float32_roundtrip_bit_exact(scheme):
    rng = np.random.default_rng(60)
    n = GROUP + 33
    if scheme in ("dict", "rle"):  # need repetition to be encodable/compact
        vocab = _f32_column(rng, 16)
        v = vocab[rng.integers(0, 16, n)]
        if scheme == "rle":
            v = np.repeat(vocab[rng.integers(0, 16, n // 64 + 1)], 64)[:n]
    else:
        v = _f32_column(rng, n)
    col = gt.encode(v, scheme)
    assert col.dtype == "float32"
    ref = gt.decode_ref(col)
    np.testing.assert_array_equal(ref.view(np.uint32), v.view(np.uint32), err_msg=scheme)
    dev = np.asarray(gt.decode(col))
    np.testing.assert_array_equal(dev.view(np.uint32), v.view(np.uint32), err_msg=scheme)


def test_float64_wide_roundtrip():
    rng = np.random.default_rng(61)
    v = rng.normal(0, 1e6, 2 * GROUP + 9)
    v[:4] = [0.0, -0.0, np.nan, -np.inf]
    col = gt.encode(v, "wide")
    out = gt.decode(col)
    np.testing.assert_array_equal(out.view(np.uint64), v.view(np.uint64))


def test_float32_predicates_match_numpy():
    rng = np.random.default_rng(62)
    v = rng.normal(0, 50, 2 * GROUP + 7).astype(np.float32)  # no NaN/-0.0
    col = gt.encode(v, "raw")
    for op, f in [("lt", np.less), ("ge", np.greater_equal), ("le", np.less_equal)]:
        for thr in (0.0, -12.5, 37.25):
            assert count_where(col, op, thr) == int(f(v, thr).sum()), (op, thr)
    np.testing.assert_array_equal(where_mask(col, "lt", 0.0), v < 0)
    # fused unpack+compare path (nbit) as well
    col2 = gt.encode(v, "nbit")
    assert count_where(col2, "gt", 10.0) == int((v > 10.0).sum())


def test_float64_predicates_match_numpy():
    rng = np.random.default_rng(63)
    v = rng.normal(0, 1e8, GROUP + 13)
    col = gt.encode(v, "wide")
    for thr in (0.0, -1e7, 3.5e7):
        assert count_where(col, "lt", thr) == int((v < thr).sum()), thr
        assert count_where(col, "ge", thr) == int((v >= thr).sum()), thr


def test_float_partial_and_take():
    rng = np.random.default_rng(64)
    v = rng.normal(0, 10, 4 * GROUP + 21).astype(np.float32)
    col = gt.encode(v, "raw")
    got = decode_groups(col, 1, 3)
    np.testing.assert_array_equal(got.view(np.uint32), v[GROUP : 3 * GROUP].view(np.uint32))
    idx = rng.integers(0, col.n, 50)
    np.testing.assert_array_equal(take(col, idx), v[idx])


def test_float32_sharded_decode():
    from giddy_tpu.dist import decode_sharded, default_mesh

    rng = np.random.default_rng(65)
    v = rng.normal(0, 10, 16 * GROUP).astype(np.float32)
    v[0] = np.nan
    col = gt.encode(v, "nbit")
    out = np.asarray(decode_sharded(col, default_mesh()))
    np.testing.assert_array_equal(out.view(np.uint32), v.view(np.uint32))


def test_float_nan_total_order_documented_semantics():
    """NaNs sit at the extremes of the total order (not all-false)."""
    v = np.array([1.0, np.nan, -np.nan, 2.0, -1.0], np.float32)
    col = gt.encode(v, "raw")
    # +NaN > any finite; -NaN < any finite (sign-bit NaN)
    assert count_where(col, "gt", 1e30) == 1
    assert count_where(col, "lt", -1e30) == 1
