"""Device-side encoders — the optional on-device encode path.

The reference keeps encoding host-side (SURVEY.md §1 'decode-only');
BASELINE's north star allows encoding on the device too. The LMP
pack is the exact inverse of the unpack loop: for each output word,
OR together the constant-shifted slot vectors that overlap it — again all
full-vector ops with compile-time shift distances.

Supported device encodes: nbit (pack), delta (lane-shift difference +
zigzag + pack), for (broadcast subtract + pack, given host-computed refs).
Bit widths/refs/anchors are host-supplied statics: width *selection* needs
a global max, which belongs on the host planning side anyway.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..format import EncodedColumn
from ..util import GROUP, LANES, SLOTS, num_groups


def pack_lanes(v: jax.Array, bits: int) -> jax.Array:
    """Inverse of unpack: (R, GROUP) uint32 values -> (R, bits*LANES) words.
    Values must already fit in `bits`."""
    terms: dict[int, list[jax.Array]] = {w: [] for w in range(bits)}
    for i in range(SLOTS):
        w0, s = divmod(i * bits, 32)
        vi = v[:, i * LANES : (i + 1) * LANES]
        terms[w0].append(vi << jnp.uint32(s) if s else vi)
        if s + bits > 32:
            terms[w0 + 1].append(vi >> jnp.uint32(32 - s))
    words = []
    for w in range(bits):
        acc = terms[w][0]
        for t in terms[w][1:]:
            acc = acc | t
        words.append(acc)
    return jnp.concatenate(words, axis=1)


_pack_jit = jax.jit(pack_lanes, static_argnums=1)


def nbit_pack_device(values: jax.Array, bits: int) -> jax.Array:
    """values: flat uint32 device array (padded to GROUP multiple) ->
    (ng, bits*LANES) packed words, computed on-device."""
    ng = num_groups(values.shape[0])
    return _pack_jit(values.reshape(ng, GROUP), bits)


def delta_streams_device(values: jax.Array, bits: int, n: int | None = None):
    """Compute the delta scheme's streams on-device: zigzag deltas packed
    LMP(bits) + per-group anchors (FORMAT.md §1.3). ``n`` is the logical
    length — tail-pad deltas are forced to 0 like the host encoder."""
    ng = num_groups(values.shape[0])
    n = values.shape[0] if n is None else n
    v = values.reshape(ng, GROUP)

    @jax.jit
    def run(v):
        prev = jnp.roll(v.reshape(-1), 1).reshape(ng, GROUP)
        j = (
            jax.lax.broadcasted_iota(jnp.int32, (ng, GROUP), 1)
            + jnp.arange(ng, dtype=jnp.int32).reshape(ng, 1) * GROUP
        )
        d = jnp.where((j == 0) | (j >= n), jnp.uint32(0), v - prev)
        z = (d << jnp.uint32(1)) ^ (-(d >> jnp.uint32(31)))
        anchors = jnp.where(
            jnp.arange(ng) == 0, jnp.roll(v[:, -1], 1) * 0 + v[0, 0], jnp.roll(v[:, -1], 1)
        )
        return z, anchors

    z, anchors = run(v)
    return nbit_pack_device(z.reshape(-1), bits), anchors


def for_streams_device(values: jax.Array, bits: int, frame_len: int):
    """Compute the FOR scheme's streams on-device: per-frame min references
    + packed offsets (FORMAT.md §1.2). ``values`` must be padded to whole
    frames (multiples of GROUP) with last-value fill like the host encoder."""
    n_pad = values.shape[0]
    ng = num_groups(n_pad)
    nf = n_pad // frame_len

    @jax.jit
    def run(v):
        frames = v.reshape(nf, frame_len)
        refs = jnp.min(frames, axis=1)
        offs = (frames - refs[:, None]).reshape(-1)
        return offs, refs

    offs, refs = run(values)
    return nbit_pack_device(offs, bits), refs


def encode_nbit_device(values: np.ndarray | jax.Array, *, bits: int, name: str = "col") -> EncodedColumn:
    """End-to-end device nbit encode returning a standard EncodedColumn
    (bit-identical to the host encoder; enforced by tests)."""
    from ..util import dtype_to_u32, pad_to_groups

    v = np.asarray(values)
    dtype = str(v.dtype)
    u = pad_to_groups(dtype_to_u32(v))
    packed = np.asarray(nbit_pack_device(jnp.asarray(u), bits))
    return EncodedColumn(
        name=name, scheme="nbit", dtype=dtype, n=v.shape[0],
        params={"bits": int(bits)}, streams={"packed": packed},
    )


_RLE_COUNT_CACHE: dict[int, object] = {}
_RLE_TABLE_CACHE: dict[tuple[int, int], object] = {}


def rle_run_counts_device(values: jax.Array) -> jax.Array:
    """Per-group run counts of a (padded) uint32 value array — the sizing
    pass of the device RLE encode (picks r_pad host-side, like the host
    encoder's counts.max())."""
    ng = num_groups(values.shape[0])
    fn = _RLE_COUNT_CACHE.get(ng)
    if fn is None:

        def counts(v):
            v = v.reshape(ng, GROUP)
            prev = jnp.concatenate([v[:, :1], v[:, :-1]], axis=1)
            j = jax.lax.broadcasted_iota(jnp.int32, (ng, GROUP), 1)
            is_start = (j == 0) | (v != prev)
            return jnp.sum(is_start, axis=1, dtype=jnp.int32)

        fn = _RLE_COUNT_CACHE[ng] = jax.jit(counts)
    return fn(values)


def rle_streams_device(values: jax.Array, r_pad: int):
    """Build the RLE run tables on-device (FORMAT.md §1.5): run starts from
    a neighbor-compare mask, run ranks from a per-group cumsum, run
    values/ends from two sorted drop-mode scatters. Values must be padded
    to whole GROUPs with last-value fill; r_pad must cover every group
    (use rle_run_counts_device)."""
    ng = num_groups(values.shape[0])
    fn = _RLE_TABLE_CACHE.get((ng, r_pad))
    if fn is None:

        def tables(v):
            v = v.reshape(ng, GROUP)
            prev = jnp.concatenate([v[:, :1], v[:, :-1]], axis=1)
            j = jax.lax.broadcasted_iota(jnp.int32, (ng, GROUP), 1)
            is_start = (j == 0) | (v != prev)
            rank = jnp.cumsum(is_start, axis=1, dtype=jnp.int32) - 1
            counts = rank[:, -1] + 1
            g = jax.lax.broadcasted_iota(jnp.int32, (ng, GROUP), 0)
            sentinel = ng * r_pad  # drop target for non-start positions
            tgt = jnp.where(is_start, g * r_pad + rank, sentinel).reshape(-1)
            # (no sortedness hint: sentinel targets interleave and collide)
            rv = (
                jnp.zeros(ng * r_pad, jnp.uint32)
                .at[tgt]
                .set(v.reshape(-1), mode="drop")
                .reshape(ng, r_pad)
            )
            # run r's end = start offset of run r+1; the group's last real
            # run (and every pad run) ends at GROUP = the init value
            tgt_e = jnp.where(
                is_start & (j > 0), g * r_pad + rank - 1, sentinel
            ).reshape(-1)
            re_ = (
                jnp.full(ng * r_pad, GROUP, jnp.int32)
                .at[tgt_e]
                .set(j.reshape(-1), mode="drop")
                .reshape(ng, r_pad)
            )
            # pad run values repeat the group's last real value (FORMAT §1.5)
            last = jnp.take_along_axis(rv, (counts - 1)[:, None], axis=1)
            r_idx = jax.lax.broadcasted_iota(jnp.int32, (ng, r_pad), 1)
            rv = jnp.where(r_idx >= counts[:, None], last, rv)
            return rv, re_, counts

        fn = _RLE_TABLE_CACHE[(ng, r_pad)] = jax.jit(tables)
    return fn(values)


def encode_rle_device(values: np.ndarray | jax.Array, *, name: str = "col") -> EncodedColumn:
    """End-to-end device RLE encode returning a standard EncodedColumn
    (bit-identical to ref/rle.py's host encoder; enforced by tests). Only
    r_pad selection (one scalar max) runs host-side."""
    from ..util import dtype_to_u32, next_power_of_2, pad_to_groups

    v = np.asarray(values)
    dtype = str(v.dtype)
    n = v.shape[0]
    u = dtype_to_u32(v)
    if n:
        u = pad_to_groups(u, fill=int(u[-1]))
    else:
        u = np.zeros(GROUP, dtype=np.uint32)
    dev = jnp.asarray(u)
    counts = rle_run_counts_device(dev)
    r_pad = max(8, next_power_of_2(int(jnp.max(counts))))
    rv, re_, cnt = rle_streams_device(dev, r_pad)
    return EncodedColumn(
        name=name, scheme="rle", dtype=dtype, n=n,
        params={"r_pad": int(r_pad)},
        streams={
            "run_values": np.asarray(rv).view(np.int32).reshape(-1),
            "run_ends": np.asarray(re_).reshape(-1),
            "run_counts": np.asarray(cnt),
        },
    )


def dict_codes_device(values: jax.Array, staged: jax.Array,
                      code_of_rank: jax.Array, n: int | None = None) -> jax.Array:
    """Device code assignment: binary-search each uint32 payload in the
    payload-sorted staging, then map the payload rank to the dictionary's
    code order (identity for floats; the signed-order permutation for
    ints — the dictionary stream is sorted in LOGICAL order, FORMAT §1.4,
    while device compares are unsigned payload compares)."""
    d = staged.shape[0]

    @jax.jit
    def run(v, dic, perm, n):
        pos = jnp.clip(jnp.searchsorted(dic, v), 0, d - 1)
        codes = perm[pos]
        # tail-pad codes are 0 like the host packer's zero fill
        i = jnp.arange(v.shape[0], dtype=jnp.int32)
        return jnp.where(i < n, codes, jnp.uint32(0))

    return run(values, staged, code_of_rank,
               jnp.int32(values.shape[0] if n is None else n))


def encode_dict_device(values: np.ndarray | jax.Array, *, bits: int | None = None,
                       name: str = "col") -> EncodedColumn:
    """Device dict encode: host builds the (small) dictionary via
    np.unique; the O(n) work — code assignment (binary search) and LMP
    pack — runs on-device. Bit-identical to ref/dict_.py's dense path."""
    from ..util import bits_needed, dtype_to_u32, pad_to_groups

    v = np.asarray(values)
    dtype = str(v.dtype)
    n = v.shape[0]
    work = dtype_to_u32(v)
    if v.dtype.kind == "f":
        dic_payload = np.unique(work)
        store = dic_payload.view(np.int32)
        order = np.arange(dic_payload.shape[0], dtype=np.uint32)
    else:
        dic_logical = np.unique(v)
        dic_payload = dtype_to_u32(dic_logical)
        store = dic_payload.astype(np.int32)
        order = np.argsort(dic_payload, kind="stable").astype(np.uint32)
    d = int(dic_payload.shape[0])
    if bits is None:
        bits = bits_needed(max(d - 1, 0))
    codes = dict_codes_device(
        jnp.asarray(pad_to_groups(work)),
        jnp.asarray(dic_payload[order.astype(np.int64)]),
        jnp.asarray(order),
        n=n,
    )
    packed = np.asarray(nbit_pack_device(codes, bits))
    return EncodedColumn(
        name=name, scheme="dict", dtype=dtype, n=n,
        params={"bits": int(bits), "dict_size": d, "dense": True},
        streams={"codes": packed, "values": store},
    )
