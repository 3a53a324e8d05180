"""Exception patching — device decoder (FORMAT.md §1.11).

Two passes on one stream, like the reference (SURVEY.md call stack CS-3):
base decode then a scatter of the exception values; the
compressed-indices variant delta-decodes the positions first (reusing the
delta decoder on the nested column). On the mesh, patch streams are
pre-partitioned per shard so the scatter stays chip-local (handled by the
dist driver).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, num_groups
from . import delta as k_delta
from .lanes import unpack_lanes, unpack_map


def prep(col: EncodedColumn) -> dict:
    streams = dict(col.streams)
    if col.params["base_scheme"] == "for":
        gpf = col.params["base_params"]["frame_len"] // GROUP
        ng = num_groups(col.n)
        refs_g = np.repeat(streams.pop("base_refs"), gpf)[:ng]
        streams["base_refs_g"] = refs_g.reshape(ng, 1)
    return streams


def build(col: EncodedColumn, out_store=None):
    bp = col.params["base_params"]
    bits = bp["bits"]
    ng = num_groups(col.n)
    count = col.params["count"]
    kind = col.params["kind"]
    base_scheme = col.params["base_scheme"]
    out_dt = out_store or jnp.uint32

    if base_scheme == "for":

        def base_decode(streams):
            ref = streams["base_refs_g"]
            u = unpack_map(streams["base_packed"], bits, lambda v, i: v + ref)
            return u.astype(out_dt).reshape(ng * GROUP)

    else:

        def base_decode(streams):
            u = unpack_lanes(streams["base_packed"], bits)
            return u.astype(out_dt).reshape(ng * GROUP)

    pos_decode = None
    if kind == "compressed" and count:
        pcol = EncodedColumn(
            name="_ppos",
            scheme="delta",
            dtype="int32",
            n=count,
            params={"bits": col.params["ppos_bits"]},
            streams={},
        )
        pos_call = k_delta.build(pcol)

        def pos_decode(streams):
            return pos_call(
                {"packed": streams["ppos_packed"], "anchors": streams["ppos_anchors"]}
            )[:count]

    def decode(streams):
        u = base_decode(streams)
        if count:
            if pos_decode is None:
                pos = streams["patch_pos"].astype(jnp.int32)
            else:
                pos = pos_decode(streams).astype(jnp.int32)
            val = streams["patch_val"]
            if out_store is not None:  # narrow the scatter values too
                val = val.astype(out_dt)
            u = u.at[pos].set(val)
        return u

    return decode


registry.register_device("patched", build, prep, narrow_store=True)
