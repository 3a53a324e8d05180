"""Delta — device decoder (FORMAT.md §1.3; BASELINE configs[1]).

The reference's warp/block inclusive scan (libgiddy ``delta.cuh`` +
``primitives/warp.cuh``, SURVEY.md CS-2 hot loop) becomes one per-group
cumsum: the per-group anchor side stream removes every cross-group carry,
so groups (and devices) never synchronize.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, num_groups
from .lanes import group_cumsum, unpack_lanes, unzigzag


def build(col: EncodedColumn, out_store=None):
    bits = col.params["bits"]
    ng = num_groups(col.n)
    out_dt = out_store or jnp.uint32

    def decode(streams):
        d = unzigzag(unpack_lanes(streams["packed"], bits))
        u = group_cumsum(d) + streams["anchors"].reshape(ng, 1)
        return u.astype(out_dt).reshape(ng * GROUP)

    return decode


registry.register_device("delta", build, narrow_store=True)
