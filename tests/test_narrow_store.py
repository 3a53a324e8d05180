"""Storage-width materialization: int8/int16 full-column decode
stores at 1/2 bytes per element instead of padded uint32 + convert pass —
the output-side analog of the reference's element-type template
specialization (SURVEY.md §3.1). The fused scan layer's uint32 payload
contract is untouched (no caller there passes ``out_store``)."""

from __future__ import annotations

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu import api
from giddy_tpu.roofline import traffic_audit
from giddy_tpu.util import GROUP

N = GROUP + 77


def _col(scheme, dt, rng):
    lo, hi = (0, 120) if dt.startswith("u") else (-50, 50)
    if scheme == "rle":
        v = (np.arange(N) // 700).astype(np.dtype(dt))
    elif scheme == "delta":
        v = np.minimum(np.arange(N) // 600, 100).astype(np.dtype(dt))
    elif scheme == "bitmap":
        v = (rng.integers(0, 4, N) * 7).astype(np.dtype(dt))
    elif scheme == "patched":
        v = rng.integers(0, 60, N).astype(np.dtype(dt))
        v[rng.choice(N, 50, replace=False)] = hi - 1
    else:
        v = rng.integers(lo, hi, N).astype(np.dtype(dt))
    return gt.encode(v, scheme), v


@pytest.mark.parametrize("dt", ["int8", "uint8", "int16", "uint16"])
@pytest.mark.parametrize(
    "scheme", ["nbit", "for", "delta", "dict", "rle", "dzbf", "bitmap", "patched"]
)
def test_narrow_store_engages_and_is_exact(scheme, dt):
    rng = np.random.default_rng(3)
    col, v = _col(scheme, dt, rng)
    store = api.narrow_store_dtype(col)
    assert store is not None and np.dtype(store).itemsize == v.dtype.itemsize
    u = api.get_decoder(col, store)(api.device_streams(col))
    assert np.dtype(str(u.dtype)).itemsize == v.dtype.itemsize  # stored narrow
    out = np.asarray(gt.decode(col))
    assert out.dtype == v.dtype
    np.testing.assert_array_equal(out, v, err_msg=f"{scheme}/{dt}")


def test_cascade_fused_lut_narrow():
    # cascade(rle) codes decode full width; only the gathered values narrow
    base = (np.arange(N // 8, dtype=np.int64) % 90).astype(np.int16)
    v = np.repeat(base, 8)[:N]
    col = gt.encode(v, "cascade", codes_scheme="rle")
    out = np.asarray(gt.decode(col))
    assert out.dtype == v.dtype
    np.testing.assert_array_equal(out, v)


def test_dict_fused_lut_narrow():
    rng = np.random.default_rng(5)
    v = rng.integers(-100, 100, N).astype(np.int8)
    col = gt.encode(v, "dict")
    np.testing.assert_array_equal(np.asarray(gt.decode(col)), v)


def test_audited_output_bytes_are_narrow():
    rng = np.random.default_rng(7)
    v = rng.integers(0, 100, N).astype(np.uint8)
    col = gt.encode(v, "nbit")
    a = traffic_audit(col)
    ng = -(-N // GROUP)
    assert a["out_bytes"] == ng * GROUP * 1  # one byte per padded element


def test_u32_contract_callers_unaffected():
    # default get_decoder (the fused-scan layer's entry) still yields u32
    rng = np.random.default_rng(9)
    v = rng.integers(0, 100, N).astype(np.uint8)
    col = gt.encode(v, "nbit")
    u = api.get_decoder(col)(api.device_streams(col))
    assert str(u.dtype) == "uint32"


@pytest.mark.parametrize(
    "scheme", ["delta", "rle", "dict", "bitmap", "dzbv", "nbit", "patched"]
)
def test_narrow_engages_on_multigrid(scheme):
    """EVERY narrow scheme keeps its narrow store at many groups: the
    output dtype is 1 or 2 bytes and the values exact."""
    n = 40 * GROUP + 5
    rng = np.random.default_rng(21)
    if scheme == "delta":
        v = (np.arange(n) % 120).astype(np.int8)
    elif scheme == "rle":
        v = ((np.arange(n) // 900) % 20000).astype(np.int16)
    elif scheme == "bitmap":
        v = (rng.integers(0, 5, n) * 3).astype(np.uint8)
    elif scheme == "dzbv":
        v = rng.integers(0, 50000, n).astype(np.uint16)
    elif scheme == "patched":
        v = np.where(rng.random(n) < 0.003, 29000, rng.integers(0, 70, n)).astype(np.int16)
    else:
        v = rng.integers(-100, 100, n).astype(np.int8)
    col = gt.encode(v, scheme)
    store = api.narrow_store_dtype(col)
    u = api.get_decoder(col, store)(api.device_streams(col))
    assert np.dtype(str(u.dtype)).itemsize == v.dtype.itemsize, (scheme, u.dtype)
    out = np.asarray(gt.decode(col))
    assert out.dtype == v.dtype
    np.testing.assert_array_equal(out, v)


def test_narrow_multiblock_grid():
    """Many groups, a uint8 column: the store stays uint8 and exact."""
    n = 40 * GROUP + 13
    rng = np.random.default_rng(13)
    v = rng.integers(0, 200, n).astype(np.uint8)
    col = gt.encode(v, "nbit")
    u = api.get_decoder(col, api.narrow_store_dtype(col))(api.device_streams(col))
    assert str(u.dtype) == "uint8"
    np.testing.assert_array_equal(np.asarray(gt.decode(col)), v)


def test_narrow_nullable_roundtrip():
    rng = np.random.default_rng(11)
    v = rng.integers(0, 100, N).astype(np.uint8)
    mask = rng.random(N) >= 0.1
    col = gt.encode(v, "nbit", valid=mask)
    out = np.asarray(gt.decode(col))
    assert out.dtype == v.dtype
    np.testing.assert_array_equal(out[mask], v[mask])
