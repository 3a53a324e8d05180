"""Streaming decode: chunked upload+decode pipeline (the PCIe-overlap
story's analog, SURVEY.md §3.11 pipeline row)."""

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu.datagen import gen_column
from giddy_tpu.stream import decode_streamed, stream_decode
from giddy_tpu.util import GROUP

SCHEMES = ["nbit", "delta", "rle", "dict", "patched", "dzbv", "alp"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_streamed_matches_full(scheme):
    rng = np.random.default_rng(33)
    v = gen_column(scheme, 7 * GROUP + 123, rng)
    col = gt.encode(v, scheme)
    out = decode_streamed(col, chunk_groups=2)
    np.testing.assert_array_equal(out, gt.decode_ref(col))


def test_streamed_wide_column():
    """64-bit columns stream plane-wise and recombine per chunk."""
    rng = np.random.default_rng(35)
    v = (rng.integers(0, 2**40, 5 * GROUP + 9, dtype=np.int64) - 2**39)
    col = gt.encode(v, "wide", base_scheme="dzbv")
    out = decode_streamed(col, chunk_groups=2)
    np.testing.assert_array_equal(out, v)
    chunks = list(stream_decode(col, chunk_groups=2))
    assert all(isinstance(c, np.ndarray) for c in chunks)
    assert chunks[0].dtype == np.int64


def test_chunk_iterator_shapes():
    rng = np.random.default_rng(34)
    v = gen_column("nbit", 5 * GROUP, rng)
    col = gt.encode(v, "nbit")
    chunks = list(stream_decode(col, chunk_groups=2, to_host=True))
    assert [c.shape[0] for c in chunks] == [2 * GROUP, 2 * GROUP, GROUP]
    np.testing.assert_array_equal(np.concatenate(chunks), v)


def test_stream_count_where_matches_numpy():
    from giddy_tpu.stream import stream_count_where

    rng = np.random.default_rng(90)
    n = 7 * GROUP + 123
    for scheme in ("nbit", "delta", "rle", "dict", "cascade", "patched"):
        v = gen_column(scheme, n, rng)
        col = gt.encode(v, scheme)
        med = int(np.median(v))
        got = stream_count_where(col, "lt", med, chunk_groups=2)
        assert got == int((v < med).sum()), scheme
    # wide 64-bit and float32 (total-order parity with count_where)
    v64 = gen_column("wide", n, rng)
    w = gt.encode(v64, "wide")
    assert stream_count_where(w, "ge", int(np.median(v64)), chunk_groups=2) == int(
        (v64 >= np.median(v64)).sum()
    )
    fv = rng.normal(0, 10, n).astype(np.float32)
    fc = gt.encode(fv, "raw")
    assert stream_count_where(fc, "lt", -1.5, chunk_groups=3) == int((fv < -1.5).sum())


def test_stream_count_patched_semantics_match_count_where():
    """Patched chunks fall back to a host compare: it must use the same
    mod-2^32 value staging as the device chunks (review regression)."""
    from giddy_tpu.query import count_where
    from giddy_tpu.stream import stream_count_where

    rng = np.random.default_rng(91)
    v = gen_column("patched", 5 * GROUP + 7, rng)
    col = gt.encode(v, "patched")
    for value in (int(np.median(v)), 2**31 + 5, -(2**31) - 3):
        want = count_where(col, "lt", value)
        assert stream_count_where(col, "lt", value, chunk_groups=2) == want, value
