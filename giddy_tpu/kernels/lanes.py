"""Shared device-side idioms: lane-sliced bit extraction, zigzag, scans.

Re-think of libgiddy's on-device primitives library
(``src/cuda/on_device/primitives/warp.cuh``, ``ptx.cuh`` bfe/funnel-shift —
SURVEY.md §3.6): because the encoder emits the lane-major packed-group
layout (FORMAT.md §0.1), every warp-shuffle/bit-field-extract trick becomes
a full-vector shift by a compile-time constant over whole ``(ng, width)``
arrays, and every warp scan a ``jnp.cumsum``/prefix-XOR along the group
row. XLA fuses the chains into the producer and consumer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..util import GROUP, LANES, SLOTS


def unpack_slot(x: jax.Array, bits: int, i: int) -> jax.Array:
    """Slot ``i`` of an LMP(bits) packed block: the (R, LANES) uint32
    vector of values at linear positions ``i*LANES + lane`` (FORMAT §0.1).
    The one shared shift/stitch step every unpack variant unrolls: all
    distances are Python constants, operands are full (R, LANES) slices."""
    mask = jnp.uint32(0xFFFFFFFF) if bits == 32 else jnp.uint32((1 << bits) - 1)
    w0, s = divmod(i * bits, 32)
    v = x[:, w0 * LANES : (w0 + 1) * LANES]
    if s:
        v = v >> jnp.uint32(s)
    if s + bits > 32:
        v = v | (x[:, (w0 + 1) * LANES : (w0 + 2) * LANES] << jnp.uint32(32 - s))
    return v & mask if bits < 32 else v


def _u32(x: jax.Array) -> jax.Array:
    return x if x.dtype == jnp.uint32 else jax.lax.bitcast_convert_type(x, jnp.uint32)


def unpack_map(x: jax.Array, bits: int, epilogue=None) -> jax.Array:
    """LMP unpack with an optional per-slot epilogue: (R, bits*LANES) uint32
    words -> (R, GROUP) values, ``epilogue(v, i)`` mapping slot ``i``'s
    (R, LANES) vector (FOR/model/ALP fuse their frame arithmetic here — the
    analog of the reference fusing the frame-ref add into the unpack loop,
    SURVEY.md CS-2). Column j = i*LANES + c of the result is the group's
    value at linear position j — outputs land in linear order by
    construction (FORMAT §0.1)."""
    x = _u32(x)
    slots = [unpack_slot(x, bits, i) for i in range(SLOTS)]
    if epilogue is not None:
        slots = [epilogue(v, i) for i, v in enumerate(slots)]
    return jnp.concatenate(slots, axis=1)


def unpack_lanes(x: jax.Array, bits: int) -> jax.Array:
    """LMP unpack: (R, bits*LANES) uint32 words -> (R, GROUP) uint32 values."""
    return unpack_map(x, bits)


def unpack_fold(x: jax.Array, bits: int, fold, init):
    """LMP unpack folding each slot vector into an accumulator:
    ``acc = fold(acc, v, i)`` over the 32 slots. The reduction sibling of
    unpack_map — used by fused predicate scans (query.py) where the
    output is smaller than the decoded block."""
    x = _u32(x)
    acc = init
    for i in range(SLOTS):
        acc = fold(acc, unpack_slot(x, bits, i), i)
    return acc


def unzigzag(z: jax.Array) -> jax.Array:
    """uint32 zigzag -> uint32 two's-complement signed payload (FORMAT §0.2)."""
    return (z >> jnp.uint32(1)) ^ (-(z & jnp.uint32(1)))


def group_cumsum(x: jax.Array) -> jax.Array:
    """Per-row inclusive cumsum along the last axis, wrapping uint32.

    Rows are groups; columns are already in linear order, so this is the
    whole of delta reconstruction within a tile (anchors remove any
    cross-tile carry — SURVEY.md §8.1 "anchors everywhere")."""
    return jnp.cumsum(x, axis=-1, dtype=jnp.uint32)


def group_cumxor(x: jax.Array) -> jax.Array:
    """Per-row inclusive prefix-XOR along the last axis — the XOR twin of
    :func:`group_cumsum`. Backbone of xordelta decode."""
    return jax.lax.associative_scan(jnp.bitwise_xor, x, axis=x.ndim - 1)


def linear_iota(rows: int) -> jax.Array:
    """(rows, GROUP) uint32 iota of within-group linear positions."""
    return jax.lax.broadcasted_iota(jnp.uint32, (rows, GROUP), 1)
