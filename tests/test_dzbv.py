"""dzbv's two-pass decode (kernels/dzbv.py) on the container's own byte
planes: exact at ragged and skewed shapes, with no host re-layout, and
through the group-range slicer (partial.GroupSlicer) that repacks each
window's planes."""

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu.api import device_streams
from giddy_tpu.partial import GroupSlicer
from giddy_tpu.util import GROUP


def _mixed(n, seed=0):
    rng = np.random.default_rng(seed)
    mag = rng.integers(0, 4, n)
    return (
        (rng.integers(0, 2**31, n).astype(np.uint32) >> (8 * (3 - mag)).astype(np.uint32))
        .astype(np.uint32)
    )


def _decode(col) -> np.ndarray:
    return np.asarray(gt.decode(col)).view(np.uint32)


@pytest.mark.parametrize("n", [100, GROUP, 3 * GROUP + 17])
def test_two_pass_exact(n):
    v = _mixed(n)
    col = gt.encode(v.view(np.int32), "dzbv")
    np.testing.assert_array_equal(_decode(col), v)


def test_streams_are_the_containers_own():
    """No host re-layout: the device streams are the encoded planes."""
    v = _mixed(4 * GROUP + 3, seed=3)
    col = gt.encode(v.view(np.int32), "dzbv")
    assert set(device_streams(col)) == set(col.streams)


def test_skewed_column():
    """All wide values clustered in a few tiles: plane ranks jump far
    between groups, which the running group offsets must carry."""
    n = 8 * GROUP
    v = np.ones(n, np.uint32)
    for g in range(8):
        v[g * GROUP : g * GROUP + 128] = 0x7F00_0001
    col = gt.encode(v.view(np.int32), "dzbv")
    np.testing.assert_array_equal(_decode(col), v)


def test_slicer_window():
    v = _mixed(6 * GROUP + 5, seed=7)
    col = gt.encode(v.view(np.int32), "dzbv")
    sub = GroupSlicer(col).slice(2, 5)
    np.testing.assert_array_equal(_decode(sub), v[2 * GROUP : 5 * GROUP])


def test_slicer_zero_byte_plane_slice():
    """A window holding no plane-3 bytes decodes from an empty plane."""
    n = 4 * GROUP
    v = np.ones(n, np.uint32)
    v[3 * GROUP + 50] = 0x0500_0000  # single 4-byte value in the last group
    v[::3] = 600  # plane1 dense everywhere
    col = gt.encode(v.view(np.int32), "dzbv")
    sub = GroupSlicer(col).slice(0, 2)  # no plane-3 bytes in this window
    np.testing.assert_array_equal(_decode(sub), v[: 2 * GROUP])
