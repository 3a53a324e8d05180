"""Dictionary — device decoder (FORMAT.md §1.4; BASELINE configs[2]).

The code unpack (kernels/nbit.py's LMP unpack) followed by one
``jnp.take`` of the dictionary — the analog of libgiddy staging the
dictionary in shared memory (``dictionary.cuh``, SURVEY.md §3.1) is left
to XLA, which may fuse the gather into the unpack. Cascade reuses the same
take after its inner code decode (kernels/cascade.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, num_groups
from .lanes import unpack_lanes


def take_values(values, codes, out_store=None):
    """``values[codes]`` at the output's storage width. Codes are in range
    by construction (the encoder emits codes < dict_size, pad codes are 0);
    unsigned codes index the take directly."""
    if out_store is not None:  # narrow the table so the take writes narrow
        values = values.astype(out_store)
    return jnp.take(values, codes, axis=0)


def build(col: EncodedColumn, out_store=None):
    bits = col.params["bits"]
    d = col.params["dict_size"]
    ng = num_groups(col.n)

    def decode(streams):
        codes = unpack_lanes(streams["codes"], bits).reshape(ng * GROUP)
        if d == 0:  # empty column: no dictionary to gather from; the
            return codes  # (all-pad) codes are the output, sliced to n == 0
        return take_values(streams["values"], codes, out_store)

    return decode


registry.register_device("dict", build, narrow_store=True)
