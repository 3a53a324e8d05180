"""NBit unpack — device decoder (FORMAT.md §1.1; BASELINE configs[0]).

Replaces libgiddy's per-lane ``bfe``/funnel-shift unpack inner loop
(SURVEY.md call stack CS-2 hot loop) with 32 constant-shift full-vector ops
per group row. Also backs dzbf (B = 8·w, FORMAT §1.9).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, num_groups
from .lanes import unpack_lanes


def build(col: EncodedColumn, out_store=None):
    bits = col.params["bits"] if col.scheme == "nbit" else 8 * col.params["width"]
    ng = num_groups(col.n)
    out_dt = out_store or jnp.uint32

    def decode(streams):
        return unpack_lanes(streams["packed"], bits).astype(out_dt).reshape(ng * GROUP)

    return decode


registry.register_device("nbit", build, narrow_store=True)
registry.register_device("dzbf", build, narrow_store=True)
