"""The plain scans (kernels/lanes.py ``group_cumsum``/``group_cumxor``)
and the scan-family decoders built on them (delta, delta2, xordelta),
against NumPy: full-range uint32 rows, values confined to byte-plane
subsets, 0/1 masks, forced wraparound, and every delta width's full
signed range."""

from __future__ import annotations

import numpy as np
import pytest

import jax.numpy as jnp

from giddy_tpu.format import EncodedColumn
from giddy_tpu.kernels import delta, delta2, lanes, xordelta
from giddy_tpu.ref.lmp import lmp_pack
from giddy_tpu.util import GROUP, zigzag


def _want(x: np.ndarray) -> np.ndarray:
    return np.cumsum(x, axis=-1, dtype=np.uint32)


def _cumsum(x: np.ndarray) -> np.ndarray:
    return np.asarray(lanes.group_cumsum(jnp.asarray(x)))


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_full_range_u32(rows):
    rng = np.random.default_rng(rows)
    x = rng.integers(0, 2**32, (rows, GROUP), dtype=np.uint32)
    assert (_cumsum(x) == _want(x)).all()


@pytest.mark.parametrize(
    "planes,small",
    [
        ((0,), True),
        ((0,), False),
        ((0, 2), True),
        ((0, 2), False),
        ((0, 1), False),
        ((1, 3), False),  # zero low byte
        ((3,), True),
    ],
)
def test_plane_subsets(planes, small):
    rng = np.random.default_rng(hash((planes, small)) % 2**31)
    hi = 128 if small else 256
    x = np.zeros((5, GROUP), np.uint32)
    for k in planes:
        x |= rng.integers(0, hi, (5, GROUP), dtype=np.uint32) << np.uint32(8 * k)
    assert (_cumsum(x) == _want(x)).all()


def test_binary_mask_small():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2, (4, GROUP), dtype=np.uint32)
    assert (_cumsum(x) == _want(x)).all()


def test_wraparound():
    # adversarial: constant huge values force uint32 wrap in every row
    x = np.full((2, GROUP), 0xFFFF_FFF1, np.uint32)
    x[1] = 0x8000_0001
    assert (_cumsum(x) == _want(x)).all()


def test_cumsum_last_axis_of_3d():
    """The scan runs along the last axis whatever the leading dims."""
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2**32, (2, 3, 1024), dtype=np.uint32)
    assert (_cumsum(x) == _want(x)).all()


def _signed(bits: int, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), shape, dtype=np.int64).astype(np.int32)


def _decode(module, params: dict, streams: dict, ng: int) -> np.ndarray:
    col = EncodedColumn(name="t", scheme="t", dtype="int32", n=ng * GROUP, params=params, streams={})
    dev = {k: jnp.asarray(v) for k, v in streams.items()}
    return np.asarray(module.build(col)(dev)).reshape(ng, GROUP)


@pytest.mark.parametrize("bits", [1, 3, 7, 8, 9, 15, 16, 17, 24, 25, 32])
def test_delta_decoder(bits):
    """The delta decoder (unpack, unzigzag, per-group cumsum, anchor) over
    the full signed range of ``bits``-wide deltas, 3 groups."""
    d = _signed(bits, (3, GROUP), bits)
    anchors = np.random.default_rng(bits + 50).integers(0, 2**32, (3, 1), dtype=np.uint32)
    packed = lmp_pack(zigzag(d.reshape(-1)).astype(np.uint32), bits)
    out = _decode(delta, {"bits": bits}, {"packed": packed, "anchors": anchors}, 3)
    want = _want(d.view(np.uint32)) + anchors
    assert (out == want).all()


@pytest.mark.parametrize("bits", [1, 3, 7, 8, 9, 15, 16, 24, 25, 32])
@pytest.mark.parametrize("rows", [1, 3])
def test_delta2_decoder(bits, rows):
    """The delta2 decoder (double cumsum + anchor + slope·(j+1)) over the
    full signed range of ``bits``-wide second differences."""
    d = _signed(bits, (rows, GROUP), bits * 10 + rows)
    rng = np.random.default_rng(bits + rows)
    anchors = rng.integers(0, 2**32, (rows, 1), dtype=np.uint32)
    slopes = rng.integers(0, 2**32, (rows, 1), dtype=np.uint32)
    packed = lmp_pack(zigzag(d.reshape(-1)).astype(np.uint32), bits)
    out = _decode(delta2, {"bits": bits},
                  {"packed": packed, "anchors": anchors, "slopes": slopes}, rows)
    pos1 = np.arange(1, GROUP + 1, dtype=np.uint32)
    want = anchors + slopes * pos1 + _want(_want(d.view(np.uint32)))
    assert (out == want).all()


def _want_xor(x: np.ndarray) -> np.ndarray:
    return np.bitwise_xor.accumulate(x, axis=1)


@pytest.mark.parametrize("rows", [1, 3, 8])
def test_cumxor(rows):
    rng = np.random.default_rng(rows + 100)
    x = rng.integers(0, 2**32, (rows, GROUP), dtype=np.uint32)
    out = np.asarray(lanes.group_cumxor(jnp.asarray(x)))
    assert (out == _want_xor(x)).all()


@pytest.mark.parametrize("bits", [1, 2, 4, 9, 32])
def test_xordelta_decoder(bits):
    """The xordelta decoder (unpack, prefix-XOR, XOR the anchor) on a
    ``bits``-wide XOR stream, 3 groups."""
    rng = np.random.default_rng(bits + 200)
    x = rng.integers(0, 1 << bits, (3, GROUP), dtype=np.uint64).astype(np.uint32)
    anchors = rng.integers(0, 2**32, (3, 1), dtype=np.uint32)
    packed = lmp_pack(x.reshape(-1), bits)
    out = _decode(xordelta, {"bits": bits}, {"packed": packed, "anchors": anchors}, 3)
    assert (out == (_want_xor(x) ^ anchors)).all()
