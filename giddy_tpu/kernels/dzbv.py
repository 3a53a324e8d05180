"""Discard zero bytes, variable — device decoder (FORMAT.md §1.10).

Two passes over the container's own compacted byte planes: for each plane
k, the rank of every element among those wider than k (a per-group cumsum
plus the groups' running offsets), then one gather of the plane byte. The
planes need no host re-layout. Measured on an H100 against a per-128-lane
tile re-layout of the planes (CHANGES.md, PR 1): the two-pass form was the
faster of the two on the device as well.

Upstream analog: libgiddy
``src/kernels/decompression/discard_zero_bytes_variable.cuh`` (SURVEY.md
§3.1) decodes varint via per-segment offset anchors + per-thread byte
loads; byte planes + a rank scan replace the per-element addressing.
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, num_groups
from .lanes import unpack_lanes


def build(col: EncodedColumn, out_store=None):
    plane_lens = col.params["plane_lens"]
    ng = num_groups(col.n)
    n_pad = ng * GROUP
    out_dt = out_store or jnp.uint32

    def decode(streams):
        w = unpack_lanes(streams["widths"], 2)  # (ng, GROUP) width - 1
        out = unpack_lanes(streams["plane0"], 8).reshape(-1)[:n_pad]
        for k in (1, 2, 3):
            if plane_lens[k] == 0:
                continue
            plane = unpack_lanes(streams[f"plane{k}"], 8).reshape(-1)
            mask = w >= jnp.uint32(k)
            c = jnp.cumsum(mask, axis=1, dtype=jnp.int32)
            tot = c[:, -1]
            rank = c + (jnp.cumsum(tot) - tot)[:, None] - 1
            # plane k holds exactly the selected elements' bytes, so a
            # selected element's rank is in range; clip bounds the rest
            vals = jnp.take(plane, rank.reshape(-1), axis=0, mode="clip")
            out = out | (jnp.where(mask.reshape(-1), vals, jnp.uint32(0)) << jnp.uint32(8 * k))
        return out.astype(out_dt)

    return decode


registry.register_device("dzbv", build, narrow_store=True)
