"""Incidence bitmaps — device decoder (FORMAT.md §1.8).

A static (unrolled) loop over the d bitmaps accumulates value[d] · bit_d —
the reference's iterate-bitmaps/ballot loop (libgiddy
``incidence_bitmaps.cuh``, SURVEY.md §3.1) as d 1-bit LMP unpacks +
multiply-adds. d is small by the scheme's nature (very low cardinality
columns), so the unroll is cheap.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, LANES, num_groups
from .lanes import unpack_lanes


def build(col: EncodedColumn, out_store=None):
    d = col.params["d"]
    ng = num_groups(col.n)
    out_dt = out_store or jnp.uint32
    if d == 0:  # empty column
        return lambda streams: jnp.zeros((ng * GROUP,), out_dt)

    def decode(streams):
        bitmaps = streams["bitmaps"].reshape(d, ng, LANES)
        values = streams["values"].reshape(d)
        acc = unpack_lanes(bitmaps[0], 1) * values[0]
        for dd in range(1, d):
            acc += unpack_lanes(bitmaps[dd], 1) * values[dd]
        return acc.astype(out_dt).reshape(ng * GROUP)

    return decode


registry.register_device("bitmap", build, narrow_store=True)
