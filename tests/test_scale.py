"""BASELINE configs[0]-[3] at full scale on the GPU: the 1 GiB int32
column packed to 9 bits, delta+FOR on sorted timestamps, a d=1000
dictionary and RLE/RPE status flags at 2**26 — each device-decoded
bit-exact.

Needs the card: ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
Elsewhere each test skips (the ``gpu`` marker's fixture in conftest.py).
"""

import numpy as np
import pytest

import giddy_tpu as gt

pytestmark = pytest.mark.gpu


def test_config0_1gib_9bit():
    n = 1 << 28  # 2**28 int32 = 1 GiB decoded
    rng = np.random.default_rng(0)
    v = rng.integers(0, 512, n, dtype=np.int64).astype(np.int32)  # 9-bit values
    col = gt.encode(v, "nbit", bits=9, name="config0")
    assert col.params["bits"] == 9
    assert col.nbytes_compressed * 3 < col.nbytes_decoded  # ~3.55x ratio
    out = np.asarray(gt.decode(col))
    np.testing.assert_array_equal(out, v)


def test_config1_delta_for_sorted_timestamps():
    """configs[1] at 256 MiB: delta+FOR on a sorted timestamp column."""
    n = 1 << 26
    rng = np.random.default_rng(1)
    ts = (np.cumsum(rng.integers(0, 4, n)) + 1_700_000_000).astype(np.int32)
    for scheme in ("delta", "for"):
        col = gt.encode(ts, scheme, name=f"config1_{scheme}")
        np.testing.assert_array_equal(np.asarray(gt.decode(col)), ts)


def test_config2_dict_low_cardinality_256mib():
    """configs[2] at 256 MiB: low-cardinality (d = 1000) dictionary column."""
    n = 1 << 26
    rng = np.random.default_rng(2)
    d = 1000
    vocab = rng.integers(-(2**31), 2**31 - 1, d, dtype=np.int64).astype(np.int32)
    v = vocab[rng.integers(0, d, n)]
    col = gt.encode(v, "dict", name="config2")
    assert col.params["dict_size"] == d
    np.testing.assert_array_equal(np.asarray(gt.decode(col)), v)


def test_config3_rle_status_flags_256mib():
    """configs[3] at 256 MiB: long-run status flags (runs 100-5000, like
    datagen's) through the per-group run-table search."""
    n = 1 << 26
    rng = np.random.default_rng(3)
    v = np.zeros(n, dtype=np.int32)
    pos = 0
    while pos < n:
        ln = int(rng.integers(100, 5000))
        v[pos : pos + ln] = int(rng.integers(0, 5))
        pos += ln
    for scheme in ("rle", "rpe"):
        col = gt.encode(v, scheme, name=f"config3_{scheme}")
        assert col.nbytes_compressed * 20 < col.nbytes_decoded
        np.testing.assert_array_equal(np.asarray(gt.decode(col)), v)
