"""Frame-of-reference — device decoder (FORMAT.md §1.2).

The reference broadcasts the frame ref via shared memory / warp shuffle
(libgiddy ``frame_of_reference.cuh``, SURVEY.md §3.1); here the per-group
reference is expanded on the host (prep_streams — 4 bytes per 128 KiB of
output) and rides in as a (ng, 1) column that broadcasts over lanes,
fused into the unpack.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, num_groups
from .lanes import unpack_map


def prep(col: EncodedColumn) -> dict:
    if "refs_g" in col.streams:  # already in per-group (dist/slice) form
        return col.streams
    gpf = col.params["frame_len"] // GROUP
    ng = num_groups(col.n)
    refs_g = np.repeat(col.streams["refs"], gpf)[:ng]
    return {"packed": col.streams["packed"], "refs_g": refs_g.reshape(ng, 1)}


def build(col: EncodedColumn, out_store=None):
    bits = col.params["bits"]
    ng = num_groups(col.n)
    out_dt = out_store or jnp.uint32

    def decode(streams):
        ref = streams["refs_g"]
        u = unpack_map(streams["packed"], bits, lambda v, i: v + ref)
        return u.astype(out_dt).reshape(ng * GROUP)

    return decode


registry.register_device("for", build, prep, narrow_store=True)
