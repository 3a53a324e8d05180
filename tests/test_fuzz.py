"""Seeded randomized sweep: scheme x size x data-shape combinations,
oracle round-trip + device-vs-oracle bit-exactness (SURVEY.md §5.2's
property-test role without a hypothesis dependency)."""

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu.datagen import gen_column
from giddy_tpu.util import GROUP

SCHEMES = ["nbit", "for", "delta", "delta2", "dict", "rle", "rpe", "model", "bitmap", "dzbf", "dzbv", "patched", "raw"]


# sizes snap to a small fixed set so device decoders compile once per
# (scheme, bits) and the randomness lives in the data, not the shapes
SIZES = [GROUP, 2 * GROUP + 999, GROUP + 17]


@pytest.mark.parametrize("trial", range(24))
def test_fuzz_roundtrip(trial):
    rng = np.random.default_rng(1000 + trial)
    scheme = SCHEMES[trial % len(SCHEMES)]
    n = SIZES[(trial // len(SCHEMES)) % len(SIZES)]  # decorrelated from scheme
    hard = bool(rng.integers(0, 2))
    v = gen_column(scheme, n, rng, hard=hard)
    col = gt.encode(v, scheme)
    ref = gt.decode_ref(col)
    np.testing.assert_array_equal(ref, v, err_msg=f"{scheme} n={n} hard={hard} (oracle)")
    dev = np.asarray(gt.decode(col))
    np.testing.assert_array_equal(dev, ref, err_msg=f"{scheme} n={n} hard={hard} (device)")


@pytest.mark.parametrize("trial", range(6))
def test_fuzz_partial_ranges(trial):
    from giddy_tpu.partial import GroupSlicer, decode_ref_groups

    rng = np.random.default_rng(2000 + trial)
    scheme = ["nbit", "delta", "rle", "for", "dict", "patched"][trial]
    v = gen_column(scheme, 5 * GROUP + 77, rng)
    col = gt.encode(v, scheme)
    sl = GroupSlicer(col)
    # fixed range widths (1 and 2) so slices share compiled decoders
    for width in (1, 2):
        g0 = int(rng.integers(0, sl.ng - width + 1))
        g1 = g0 + width
        np.testing.assert_array_equal(
            sl.decode(g0, g1), decode_ref_groups(col, g0, g1),
            err_msg=f"{scheme} [{g0},{g1})",
        )
