"""Device decoder vs CPU oracle: bit-exact on every scheme
(SURVEY.md §5.2.2 — the core equivalence suite). Runs the same XLA
programs the GPU runs, compiled by XLA:CPU."""

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu.util import GROUP

from helpers import gen_column

SCHEMES = ["nbit", "for", "delta", "delta2", "dict", "rle", "rpe", "model", "bitmap", "dzbf", "dzbv", "patched", "raw", "xordelta", "alp"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_device_matches_oracle(scheme):
    rng = np.random.default_rng(1234)
    v = gen_column(scheme, 2 * GROUP + 999, rng)
    col = gt.encode(v, scheme)
    ref = gt.decode_ref(col)
    dev = np.asarray(gt.decode(col))
    np.testing.assert_array_equal(dev, ref)
    np.testing.assert_array_equal(dev, v)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_device_matches_oracle_hard(scheme):
    rng = np.random.default_rng(99)
    v = gen_column(scheme, GROUP, rng, hard=True)
    col = gt.encode(v, scheme)
    np.testing.assert_array_equal(np.asarray(gt.decode(col)), gt.decode_ref(col))


@pytest.mark.parametrize("bits", [1, 7, 9, 16, 17, 31, 32])
def test_nbit_widths_device(bits):
    rng = np.random.default_rng(bits)
    hi = (1 << bits) - 1 if bits < 32 else 2**32 - 1
    v = rng.integers(0, hi + 1, GROUP + 1, dtype=np.uint64).astype(np.uint32).view(np.int32)
    col = gt.encode(v, "nbit", bits=bits)
    np.testing.assert_array_equal(np.asarray(gt.decode(col)), v)


def test_patched_compressed_device():
    rng = np.random.default_rng(5)
    v = gen_column("patched", 3 * GROUP, rng)
    col = gt.encode(v, "patched", kind="compressed")
    np.testing.assert_array_equal(np.asarray(gt.decode(col)), v)


@pytest.mark.parametrize("scheme", SCHEMES + ["cascade"])
def test_device_empty_column(scheme):
    """n=0 decodes to an empty array on the device path (SURVEY §5.2.2;
    VERDICT r1 edge-matrix item)."""
    rng = np.random.default_rng(0)
    v = gen_column(scheme, 0, rng)
    col = gt.encode(v, scheme)
    out = np.asarray(gt.decode(col))
    assert out.shape == (0,) and out.dtype == v.dtype
    assert gt.decode_ref(col).shape == (0,)


def test_device_adversarial_edges():
    """dict size 1, single-run RLE/RPE (run length == n), and
    all-exceptions patching — device vs oracle (SURVEY.md §5.2.2)."""
    n = 2 * GROUP + 999
    const = np.full(n, -7, np.int32)
    for scheme in ("dict", "rle", "rpe"):
        col = gt.encode(const, scheme)
        np.testing.assert_array_equal(np.asarray(gt.decode(col)), const)
    rng = np.random.default_rng(2)
    spread = rng.integers(2, 2**20, n, dtype=np.int64).astype(np.int32)
    for kind in ("naive", "compressed"):
        col = gt.encode(spread, "patched", kind=kind, bits=1)  # forces all but
        assert col.params["count"] >= 0.99 * n  # frame-min hits into patches
        np.testing.assert_array_equal(np.asarray(gt.decode(col)), spread)
        np.testing.assert_array_equal(gt.decode_ref(col), spread)


def test_decoder_cache_reuse():
    rng = np.random.default_rng(8)
    v = gen_column("nbit", GROUP, rng)
    col1 = gt.encode(v, "nbit", bits=10)
    col2 = gt.encode(v + 1, "nbit", bits=10)
    assert gt.get_decoder(col1) is gt.get_decoder(col2)
