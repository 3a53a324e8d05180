"""Odd group counts: columns whose group count divides no power of two
(regression for a 127-group dzbv lowering failure)."""

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu.datagen import gen_column
from giddy_tpu.util import GROUP

SCHEMES = ["nbit", "for", "delta", "delta2", "dict", "rle", "model", "dzbf", "dzbv", "patched"]


@pytest.mark.parametrize("scheme", SCHEMES)
def test_odd_group_count(scheme):
    rng = np.random.default_rng(123)
    v = gen_column(scheme, 9 * GROUP + 1, rng)
    col = gt.encode(v, scheme)
    np.testing.assert_array_equal(np.asarray(gt.decode(col)), gt.decode_ref(col))


def test_bitmap_high_cardinality_fallback():
    rng = np.random.default_rng(5)
    vocab = np.arange(100, dtype=np.int32) * 3 - 50
    v = vocab[rng.integers(0, 100, GROUP + 9)]
    col = gt.encode(v, "bitmap")
    assert col.params["d"] == 100
    np.testing.assert_array_equal(np.asarray(gt.decode(col)), v)
