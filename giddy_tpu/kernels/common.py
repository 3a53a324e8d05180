"""Plumbing shared by all device decoders: host streams -> device arrays.

Every decoder is a plain jitted ``jax.numpy``/``lax`` program over whole
``(ng, width)`` group-major arrays; XLA fuses unpack, epilogue and store
into one pass (docs/DESIGN.md §3).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def to_device_streams(streams: dict[str, np.ndarray]) -> dict[str, jax.Array]:
    """Host streams -> device arrays; packed word streams go up as uint32."""
    out = {}
    for k, v in streams.items():
        if v.dtype in (np.int32, np.uint32):
            v = v.view(np.uint32)
        out[k] = jnp.asarray(v)
    return out
