"""Per-frame model (linear / quadratic) — device decoder (FORMAT.md §1.7).

Prediction a + b·p (+ c·p² for ``kind="poly2"``) is evaluated
elementwise. The per-group affine terms (A_g = a_f + b_f·p0 + c_f·p0²,
B_g = b_f + 2·c_f·p0, C_g = c_f — the polynomial shifted to the group
start, exact in uint32 wrap space) are expanded on the HOST (prep_streams)
and cross the jit boundary as (ng, 1) arguments — an XLA constant-gather
prologue for this costs milliseconds of dispatch on some backends, host
NumPy costs microseconds. (libgiddy ``model.cuh`` analog, SURVEY.md §3.1.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, LANES, num_groups
from .lanes import unpack_map, unzigzag


def prep(col: EncodedColumn) -> dict:
    if "a_g" in col.streams:  # already in per-group (dist/slice) form
        return col.streams
    frame_len = col.params["frame_len"]
    ng = num_groups(col.n)
    g = np.arange(ng, dtype=np.int64)
    f = (g * GROUP) // frame_len
    p0 = (g * GROUP) % frame_len
    a = col.streams["coef_a"].astype(np.int64)[f]
    b = col.streams["coef_b"].astype(np.int64)[f]
    poly2 = col.params.get("kind") == "poly2"
    c = col.streams["coef_c"].astype(np.int64)[f] if poly2 else np.int64(0)
    # polynomial shifted to the group start: a' = a + b·p0 + c·p0²,
    # b' = b + 2·c·p0, c' = c (exact mod 2^32)
    a_g = ((a + b * p0 + c * p0 * p0) & 0xFFFFFFFF).astype(np.uint32)
    b_g = ((b + 2 * c * p0) & 0xFFFFFFFF).astype(np.uint32)
    out = {
        "packed": col.streams["packed"],
        "a_g": a_g.reshape(ng, 1),
        "b_g": b_g.reshape(ng, 1),
    }
    if poly2:
        out["c_g"] = (c & 0xFFFFFFFF).astype(np.uint32).reshape(ng, 1)
    return out


def build(col: EncodedColumn, out_store=None):
    bits = col.params["bits"]
    ng = num_groups(col.n)
    poly2 = col.params.get("kind") == "poly2"
    out_dt = out_store or jnp.uint32

    def decode(streams):
        a, b = streams["a_g"], streams["b_g"]
        # slot i's positions are p = i*LANES + lane. Linear: pred =
        # (a + b*lane) + (b*LANES)*i. Quadratic adds c*p² =
        # c*lane² + (2*LANES*c*lane)*i + (c*LANES²)*i² — every i-term has a
        # compile-time coefficient, so the whole epilogue stays full-vector
        # multiply-adds.
        lane = jax.lax.broadcasted_iota(jnp.uint32, (ng, LANES), 1)
        base = a + b * lane
        step = b * jnp.uint32(LANES)
        if poly2:
            c = streams["c_g"]
            base = base + c * (lane * lane)
            step = step + (c * jnp.uint32(2 * LANES)) * lane
            step2 = c * jnp.uint32(LANES * LANES)
            epi = lambda v, i: (
                base + step * jnp.uint32(i) + step2 * jnp.uint32(i * i) + unzigzag(v)
            )
        else:
            epi = lambda v, i: base + step * jnp.uint32(i) + unzigzag(v)
        u = unpack_map(streams["packed"], bits, epi)
        return u.astype(out_dt).reshape(ng * GROUP)

    return decode


registry.register_device("model", build, prep, narrow_store=True)
