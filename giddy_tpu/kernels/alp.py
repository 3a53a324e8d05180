"""ALP decimal-float decode — device decoder (FORMAT.md §1.16).

One pass, FOR-shaped (like kernels/for_.py): per-GROUP refs ride as a
(ng, 1) column, the int reconstruction + float multiply + ulp correction
fuse into the unpack epilogue (the correction stream unpacks slot-in-step
with the offsets), exceptions scatter after (XLA aliases the update in
place, same as kernels/patch.py).

Cross-platform bit-exactness is by construction (see ref/alp.py): the
only float ops are an int32→f32 convert and one f32 multiply — single
correctly-rounded IEEE ops on NumPy and on the device — and everything
else is uint32 wrap arithmetic. Device f32 division need not be correctly
rounded, which is why the format carries the correction stream instead of
decoding with a divide.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, num_groups
from .lanes import unpack_map, unpack_slot, unzigzag


def prep(col: EncodedColumn) -> dict:
    if "refs_g" in col.streams:  # already in per-group (dist/slice) form
        return col.streams
    ng = num_groups(col.n)
    s = dict(col.streams)
    s["refs_g"] = s.pop("refs").reshape(ng, 1)
    return s


def build(col: EncodedColumn):
    bits = col.params["bits"]
    corr_bits = col.params["corr_bits"]
    e = col.params["exp_e"]
    count = col.params["count"]
    ng = num_groups(col.n)
    scale = np.float32(10.0**-e)

    def decode(streams):
        ref = streams["refs_g"]
        xc = streams["corr"]

        def epi(v, i):
            enc = jax.lax.bitcast_convert_type(v + ref, jnp.int32)
            m = enc.astype(jnp.float32) * scale
            corr = unzigzag(unpack_slot(xc, corr_bits, i))
            return jax.lax.bitcast_convert_type(m, jnp.uint32) + corr

        u = unpack_map(streams["packed"], bits, epi).reshape(ng * GROUP)
        if count:
            pos = streams["patch_pos"].astype(jnp.int32)
            u = u.at[pos].set(streams["patch_val"])
        return u

    return decode


registry.register_device("alp", build, prep)
