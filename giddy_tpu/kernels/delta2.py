"""Delta-of-delta — device decoder (FORMAT.md §1.17; beyond-parity scheme).

The delta decoder (libgiddy ``delta.cuh`` re-think, kernels/delta.py) run to
second order: unpack, two per-group cumsums, then the affine anchor+slope
epilogue. The per-group (anchor, slope) pair removes every cross-group
carry, so groups and mesh shards stay independent exactly like delta.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, num_groups
from .lanes import group_cumsum, linear_iota, unpack_lanes, unzigzag


def build(col: EncodedColumn, out_store=None):
    bits = col.params["bits"]
    ng = num_groups(col.n)
    out_dt = out_store or jnp.uint32

    def decode(streams):
        s = unzigzag(unpack_lanes(streams["packed"], bits))
        cc = group_cumsum(group_cumsum(s))
        pos1 = linear_iota(ng) + jnp.uint32(1)
        anchors = streams["anchors"].reshape(ng, 1)
        slopes = streams["slopes"].reshape(ng, 1)
        u = anchors + slopes * pos1 + cc
        return u.astype(out_dt).reshape(ng * GROUP)

    return decode


registry.register_device("delta2", build, narrow_store=True)
