"""Predicate pushdown: decode-and-filter in one fused program.

libgiddy exists to feed DBMS scans (SURVEY.md §1 — MonetDB columns); the
natural extension is evaluating the scan predicate *inside* the decode
program so the full-width column never touches HBM: XLA fuses the unpack and
compare into one pass that reads the packed stream and writes a 1-bit incidence bitmap (LMP(1) layout, 1/32 of
the decoded bytes). Supported for the unpack-epilogue schemes (nbit, dzbf,
for); other schemes fall back to decode + compare in one jit.

The comparison value rides in at runtime (a jit argument), so scanning
many thresholds reuses ONE compiled program per (column, op).
Comparisons follow the column's logical dtype semantics, including
sign-extension of narrow (int8/int16) payloads. 64-bit ``wide`` columns
compare plane-split: both 32-bit planes decode on device and the 64-bit
ordering is pieced from (hi, lo) halves — no int64 device arrays. Float
columns compare in IEEE total order (monotone bitpattern keys): regular
values match float semantics exactly; the deviations are -0.0 < +0.0
(and != +0.0), and NaNs ordered at the extremes instead of
all-comparisons-false.

Dictionary-backed columns (dict and cascade) get a **dict-domain
pushdown**: the predicate is evaluated over the dictionary host-side
(O(dict_size)) and rewritten as code range scans — the value gather never
runs, and when the code scheme is nbit/for/dzbf the scan is the fused
epilogue program. Fragmented match sets (possible only with unsorted
explicit dictionaries) fall back to decode+compare.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .format import EncodedColumn
from .util import GROUP, LANES, SLOTS, np_dtype, num_groups

_OPS = ("eq", "ne", "lt", "le", "gt", "ge")


def _total_order_u32(v):
    """IEEE-754 bitpattern -> monotone uint32 key: flip all bits of
    negatives, flip only the sign bit of non-negatives. Unsigned compare of
    keys then matches float ordering (total order: -NaN < -inf < ... <
    -0.0 < +0.0 < ... < +inf < +NaN; ±0.0 compare unequal)."""
    neg = jnp.uint32(0) - (v >> jnp.uint32(31))  # 0xFFFFFFFF where negative
    return v ^ (jnp.uint32(0x80000000) | neg)


def _cmp(v, c, op: str, kind: str, itemsize: int):
    """Compare uint32 payloads against scalar c in logical-dtype semantics
    (kind = numpy dtype kind: 'i'/'u'/'f'). Narrow signed payloads are
    zero-extended at encode; sign-extend with an arithmetic shift pair
    before comparing. Float payloads map through the total-order key —
    ``c`` must arrive already in comparison form (int32 for signed,
    total-order-mapped uint32 for floats), prepared host-side."""
    if kind == "i":
        v = jax.lax.bitcast_convert_type(v, jnp.int32)
        k = 32 - 8 * itemsize
        if k:  # sign-extend narrow payloads (jnp >> on int32 is arithmetic)
            v = (v << k) >> k
    elif kind == "f":
        v = _total_order_u32(v)
    return {
        "eq": v == c, "ne": v != c, "lt": v < c,
        "le": v <= c, "gt": v > c, "ge": v >= c,
    }[op]


def _epilogue_filter_call(col: EncodedColumn, op: str):
    """Fused unpack+compare -> (ng, LANES) bitmap words; the comparison
    value arrives as a traced (1, 1) argument, so every threshold reuses
    one compiled program per (column, op)."""
    from .kernels.lanes import unpack_fold

    scheme = col.scheme
    bits = col.params["bits"] if scheme in ("nbit", "for") else 8 * col.params["width"]
    ng = num_groups(col.n)
    dt = np_dtype(col.dtype)
    kind, itemsize = dt.kind, dt.itemsize

    def call(streams, val):
        ref = streams["refs_g"] if scheme == "for" else None
        c = val[0, 0]

        def fold(acc, v, i):
            if ref is not None:
                v = v + ref
            hit = _cmp(v, c, op, kind, itemsize).astype(jnp.uint32)
            return acc | (hit << jnp.uint32(i))

        return unpack_fold(streams["packed"], bits, fold, jnp.zeros((ng, LANES), jnp.uint32))

    return call


def _wide_hits(lo, hi, clo, chi_u, kind: str, op: str):
    """64-bit comparison pieced from 32-bit (lo, hi) plane halves: hi
    ordered in the logical signedness (floats via the total-order key —
    flip all 64 bits of negatives, only the sign bit of non-negatives;
    the value halves arrive pre-mapped), lo always unsigned. Returns the
    boolean hit array (shared with dist_query's sharded twin)."""
    if kind == "f":
        neg = jnp.uint32(0) - (hi >> jnp.uint32(31))
        hi = hi ^ (jnp.uint32(0x80000000) | neg)
        lo = lo ^ neg
        hi_o, chi_o = hi, chi_u
    elif kind == "i":
        hi_o = jax.lax.bitcast_convert_type(hi, jnp.int32)
        chi_o = jax.lax.bitcast_convert_type(chi_u, jnp.int32)
    else:
        hi_o, chi_o = hi, chi_u
    eq = (hi == chi_u) & (lo == clo)
    lt = (hi_o < chi_o) | ((hi == chi_u) & (lo < clo))
    return {
        "eq": eq, "ne": ~eq, "lt": lt,
        "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt,
    }[op]


def _wide_filter_fn(col: EncodedColumn, op: str):
    """Bitmap builder for 64-bit (wide) columns: decode both 32-bit planes
    on device and compare with 64-bit semantics pieced from the halves —
    the int64 values themselves never materialize on device (wide.py)."""
    from . import wide
    from .api import get_decoder

    lo_col, hi_col = wide._sub(col, "lo"), wide._sub(col, "hi")
    ng = num_groups(col.n)
    kind = np_dtype(col.dtype).kind
    dlo, dhi = get_decoder(lo_col), get_decoder(hi_col)

    def general(slo, shi, val):
        lo = dlo(slo).reshape(ng, SLOTS, LANES)
        hi = dhi(shi).reshape(ng, SLOTS, LANES)
        hits = _wide_hits(lo, hi, val[0, 0], val[0, 1], kind, op).astype(jnp.uint32)
        i = jax.lax.broadcasted_iota(jnp.uint32, (1, SLOTS, 1), 1)
        return jnp.sum(hits << i, axis=1, dtype=jnp.uint32)

    return jax.jit(general)


def _host_key_u32(u: np.ndarray) -> np.ndarray:
    """Host twin of _total_order_u32 (uint32 bitpatterns -> monotone keys)."""
    u = u.astype(np.uint32)
    neg = np.where(u >> np.uint32(31), np.uint32(0xFFFFFFFF), np.uint32(0))
    return u ^ (np.uint32(0x80000000) | neg)


def host_cmp_mask(u: np.ndarray, op: str, value, dtype: str) -> np.ndarray:
    """Host twin of the device compare: uint32 payloads vs a scalar, with
    identical semantics to _cmp + _stage_value (mod-2^32 staging of
    out-of-range ints, sign-extension of narrow payloads, float total
    order). Shared by the dict-domain pushdown and streaming fallbacks."""
    from .util import NP_CMP

    dt = np_dtype(dtype)
    u = u.view(np.uint32)
    if dt.kind == "f":
        keys = _host_key_u32(u)
        cval = _host_key_u32(np.float32(value).view(np.uint32).reshape(1))[0]
    elif dt.kind == "i":
        k = 32 - 8 * dt.itemsize
        keys = (u.view(np.int32) << k) >> k if k else u.view(np.int32)
        cval = np.array(value, np.int64).astype(np.uint32).view(np.int32)
    else:
        keys = u
        cval = np.array(value, np.int64).astype(np.uint32)
    return NP_CMP[op](keys, cval)


def _dict_code_ranges(col: EncodedColumn, op: str, value) -> list[tuple[int, int]] | None:
    """Evaluate the predicate over the DICTIONARY (host, O(dict_size)) and
    return the matching codes as contiguous [start, end) ranges — the
    dict-domain pushdown for dict and cascade columns: the scan never
    needs the value gather, only code range scans. Returns None when the
    match set is too fragmented to beat the decode+compare fallback."""
    mask = host_cmp_mask(col.streams["values"].view(np.uint32), op, value, col.dtype)
    bounds = np.flatnonzero(np.diff(mask.astype(np.int8), prepend=0, append=0))
    ranges = list(zip(bounds[0::2].tolist(), bounds[1::2].tolist()))
    # sorted dictionaries give <=1 range for ordered ops on ints, <=2 for
    # floats (bitpattern order splits the negatives); beyond a handful, the
    # OR-of-range-scans loses to one decode+compare pass
    return ranges if len(ranges) <= 4 else None


def _dict_filter_bitmap(col: EncodedColumn, op: str, value):
    """filter_bitmap for dict/cascade columns via code range scans."""
    from .groupby import _codes_device_column

    ranges = _dict_code_ranges(col, op, value)
    if ranges is None:
        return None  # caller falls back to decode+compare
    inner = _codes_device_column(col)
    acc = None
    for s, e in ranges:
        if e - s == 1:
            bm = filter_bitmap(inner, "eq", s)
        elif s == 0:
            bm = filter_bitmap(inner, "lt", e)
        elif e == col.params["dict_size"]:
            bm = filter_bitmap(inner, "ge", s)
        else:
            bm = between_bitmap(inner, s, e - 1)
        acc = bm if acc is None else (acc | bm)
    if acc is None:
        acc = jnp.zeros((num_groups(col.n), LANES), jnp.uint32)
    return acc


def _stage_value(dtype: str, value) -> np.ndarray:
    """Host-stage a comparison value into the (1, 1) form _cmp expects:
    int32 for signed columns (wrap-exact via int64 staging), total-order-
    mapped uint32 for floats, raw uint32 otherwise."""
    dk = np_dtype(dtype).kind
    if dk == "f":
        u = np.float32(value).view(np.uint32)
        neg = np.uint32(0xFFFFFFFF) if (u >> np.uint32(31)) else np.uint32(0)
        return np.array([[u ^ (np.uint32(0x80000000) | neg)]], np.uint32)
    ctype = np.int32 if dk == "i" else np.uint32
    return np.array([[value]], dtype=np.int64).astype(np.uint32).view(ctype)


def _stage_value_wide(dtype: str, value) -> np.ndarray:
    """64-bit staging: (1, 2) uint32 [lo, hi] halves, floats pre-mapped to
    the 64-bit total-order key."""
    dk = np_dtype(dtype).kind
    dt = {"i": np.int64, "u": np.uint64, "f": np.float64}[dk]
    u = np.array(value, dtype=dt).view(np.uint64)
    if dk == "f":
        neg = np.uint64(0xFFFFFFFFFFFFFFFF) if (u >> np.uint64(63)) else np.uint64(0)
        u = u ^ (np.uint64(0x8000000000000000) | neg)
    return np.array(
        [[u & np.uint64(0xFFFFFFFF), u >> np.uint64(32)]], np.uint64
    ).astype(np.uint32)


_FILTER_CACHE: dict[tuple, object] = {}


def filter_bitmap(col: EncodedColumn, op: str, value: int) -> jax.Array:
    """(ng, LANES) uint32 bitmap words in LMP(1) layout: bit i of word
    [g, c] = predicate(col[g*GROUP + i*LANES + c]). Pad positions beyond n
    are garbage — count_where masks them; slice after unpacking otherwise."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    from . import nulls
    from .api import device_streams, get_decoder
    from .util import check_device_addressable

    check_device_addressable(col.n, f"scan of {col.name!r}")
    nullable = nulls.is_nullable(col)  # SQL: NULL never matches — AND validity
    if col.scheme in ("cascade", "dict"):
        bm = _dict_filter_bitmap(col, op, value)
        if bm is not None:
            return bm & nulls.valid_words_device(col) if nullable else bm
        # fragmented match set: fall through to decode+compare

    if col.scheme == "wide":
        from . import wide

        key = (col.static_key(), op)
        fn = _FILTER_CACHE.get(key)
        if fn is None:
            fn = _FILTER_CACHE[key] = _wide_filter_fn(col, op)
        val = jnp.asarray(_stage_value_wide(col.dtype, value))
        bm = fn(
            device_streams(wide._sub(col, "lo")),
            device_streams(wide._sub(col, "hi")),
            val,
        )
        return bm & nulls.valid_words_device(col) if nullable else bm

    key = (col.static_key(), op)
    fn = _FILTER_CACHE.get(key)
    if fn is None:
        if col.scheme in ("nbit", "dzbf", "for"):
            base = _epilogue_filter_call(col, op)
        else:
            ng = num_groups(col.n)
            dt = np_dtype(col.dtype)
            kind, itemsize = dt.kind, dt.itemsize
            decoder = get_decoder(col)

            def base(streams, val):
                u = decoder(streams).reshape(ng, SLOTS, LANES)
                hits = _cmp(u, val[0, 0], op, kind, itemsize).astype(jnp.uint32)
                i = jax.lax.broadcasted_iota(jnp.uint32, (1, SLOTS, 1), 1)
                # bits occupy distinct positions, so sum == bitwise-or
                return jnp.sum(hits << i, axis=1, dtype=jnp.uint32)

        if nullable:  # validity folds into the same dispatch
            fn = jax.jit(lambda streams, val, vw, _b=base: _b(streams, val) & vw)
        else:
            fn = jax.jit(base)
        _FILTER_CACHE[key] = fn
    args = (device_streams(col), jnp.asarray(_stage_value(col.dtype, value)))
    return fn(*args, nulls.valid_words_device(col)) if nullable else fn(*args)


def _tail_mask(n: int) -> np.ndarray:
    """(LANES,) uint32 valid-bit words for the LAST group only; all earlier
    groups are fully valid."""
    ng = num_groups(n)
    base = (ng - 1) * GROUP
    i = np.arange(SLOTS)[:, None]
    c = np.arange(LANES)[None, :]
    valid = (base + i * LANES + c) < n
    keep = np.zeros(LANES, np.uint32)
    for ii in range(SLOTS):
        keep |= valid[ii].astype(np.uint32) << np.uint32(ii)
    return keep


def _mask_pad(words, n: int):
    """Zero the bits of pad positions (only the final group can hold any)."""
    ng = num_groups(n)
    if n < ng * GROUP:
        words = words.at[ng - 1].set(words[ng - 1] & jnp.asarray(_tail_mask(n)))
    return words


def popcount_words(x):
    """SWAR popcount per uint32 word (traced; shared with dist_query)."""
    x = x - ((x >> jnp.uint32(1)) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> jnp.uint32(2)) & jnp.uint32(0x33333333))
    x = (x + (x >> jnp.uint32(4))) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> jnp.uint32(24)


def count_bits(words, n: int) -> int:
    """Population count of an LMP(1) bitmap over a column of n elements
    (pad bits masked). Accepts the output of filter_bitmap / combinators."""
    return int(jnp.sum(popcount_words(_mask_pad(jnp.asarray(words), n))))


def count_where(col: EncodedColumn, op: str, value: int) -> int:
    """Number of elements satisfying the predicate (pad bits masked)."""
    return count_bits(filter_bitmap(col, op, value), col.n)


# --- bitmap algebra -------------------------------------------------------
# Predicates compose on the 1-bit-per-element bitmaps (1/32 of decoded
# bytes), never on decoded values — the DBMS scan pipeline shape. All of
# these stay on device.


def bitmap_and(a, b):
    return jnp.asarray(a) & jnp.asarray(b)


def bitmap_or(a, b):
    return jnp.asarray(a) | jnp.asarray(b)


def bitmap_not(words, n: int):
    """Complement within the column (pad bits forced to 0). SQL NOT over a
    nullable column's predicate must also exclude the nulls: AND the result
    with nulls.notnull_bitmap(col) (NOT(unknown) is unknown, not true)."""
    return _mask_pad(~jnp.asarray(words), n)


def between_bitmap(col: EncodedColumn, lo: int, hi: int):
    """Bitmap of lo <= col[i] <= hi (inclusive both ends)."""
    return bitmap_and(filter_bitmap(col, "ge", lo), filter_bitmap(col, "le", hi))


def count_between(col: EncodedColumn, lo: int, hi: int) -> int:
    return count_bits(between_bitmap(col, lo, hi), col.n)


def isin_bitmap(col: EncodedColumn, values) -> "jax.Array":
    """Bitmap of membership in a value set. Small sets OR eq scans (one
    compiled kernel total — the compare value is a runtime argument);
    larger sets run ONE device pass: vectorized binary search of each
    decoded payload in the sorted staged set. Wide (64-bit) columns search
    both planes lexicographically (`_isin_searched_wide`). Floats match in
    bitpattern space (exact for everything except that -0.0 does not match
    +0.0, and NaNs match equal-payload NaNs — the same convention as the
    dictionary build)."""
    dk = np_dtype(col.dtype).kind
    if col.scheme == "wide":
        return _isin_searched_wide(col, values)
    if dk == "f":
        fv = np.asarray(np.asarray(values, dtype=object).reshape(-1), np.float32)
        u, ix = np.unique(fv.view(np.uint32), return_index=True)
        if u.size == 0:
            return jnp.zeros((num_groups(col.n), LANES), jnp.uint32)
        if u.size > 8:
            return _isin_searched(col, [int(x) for x in u])
        acc = None
        for i in np.sort(ix):
            # stage the float32 scalar itself — a Python-float round-trip
            # would quiet signaling-NaN payloads, diverging from the raw-
            # bitpattern staging of the searched (>8 values) path
            bm = filter_bitmap(col, "eq", fv[i])
            acc = bm if acc is None else acc | bm
        return acc
    vals = list(dict.fromkeys(int(v) for v in np.asarray(values).reshape(-1)))
    dt = np_dtype(col.dtype)
    if dt.itemsize < 4 and vals:
        # drop values the logical dtype cannot represent — identical rule
        # to _staged_set_u32, so both set sizes give the same membership
        # (the eq scan's mod-2^32 staging would otherwise alias e.g.
        # 2^32-5 onto int8 -5)
        bits = 8 * dt.itemsize
        lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if dt.kind == "i" else (0, (1 << bits) - 1)
        vals = [v for v in vals if lo <= v <= hi]
    if not vals:
        return jnp.zeros((num_groups(col.n), LANES), jnp.uint32)
    if len(vals) > 8:
        return _isin_searched(col, vals)
    acc = filter_bitmap(col, "eq", vals[0])
    for v in vals[1:]:
        acc = acc | filter_bitmap(col, "eq", v)
    return acc


def _staged_set_u32(dtype: str, vals) -> np.ndarray | None:
    """Host-stage an integer value set for a 32-bit payload search: values
    masked to the payload width (narrow ints are stored zero-extended, so
    an int8 -5 is payload 0xFB; narrow dtypes first drop unrepresentable
    values — isin_bitmap's eq-scan path applies the identical rule, so set
    size never changes membership; 32-bit keeps the documented mod-2^32
    staging), sorted, deduped,
    padded to a power of two by repeating the maximum (stays sorted, so
    set sizes share compilations). None = provably empty match set."""
    dt = np_dtype(dtype)
    bits = 8 * dt.itemsize
    if bits < 32:
        lo, hi = (-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if dt.kind == "i" else (0, (1 << bits) - 1)
        vals = [v for v in vals if lo <= v <= hi]
        if not vals:
            return None
    staged = np.unique(
        (np.array(vals, dtype=np.int64) & ((1 << bits) - 1)).astype(np.uint32)
    )
    m = 1 << (int(staged.size - 1).bit_length())
    return np.concatenate([staged, np.repeat(staged[-1:], m - staged.size)])


def _staged_set_u64(dtype: str, values) -> tuple[np.ndarray, np.ndarray] | None:
    """64-bit twin of _staged_set_u32: (lo, hi) uint32 plane pairs sorted
    lexicographically by (hi, lo), deduped, pow2-padded. Floats stage as
    raw float64 bitpatterns. None = provably empty."""
    dt = np_dtype(dtype)
    vals = np.asarray(values, dtype=object).reshape(-1)
    if dt.kind == "f":
        u = np.array([float(v) for v in vals], np.float64).view(np.uint64)
    else:
        lo_b, hi_b = (0, 2**64) if dt.kind == "u" else (-(2**63), 2**63)
        kept = [int(v) for v in vals if lo_b <= int(v) < hi_b]
        u = np.array(kept, dtype=np.int64 if dt.kind == "i" else np.uint64).view(np.uint64)
    if u.size == 0:
        return None
    slo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    shi = (u >> np.uint64(32)).astype(np.uint32)
    order = np.lexsort((slo, shi))
    slo, shi = slo[order], shi[order]
    keep = np.ones(slo.size, bool)
    keep[1:] = (slo[1:] != slo[:-1]) | (shi[1:] != shi[:-1])
    slo, shi = slo[keep], shi[keep]
    m = 1 << (int(slo.size - 1).bit_length())
    slo = np.concatenate([slo, np.repeat(slo[-1:], m - slo.size)])
    shi = np.concatenate([shi, np.repeat(shi[-1:], m - shi.size)])
    return slo, shi


def _isin_searched(col: EncodedColumn, vals):
    """One-jit membership: decode -> searchsorted into the staged set.
    The set is a runtime argument padded to a power of two (repeating its
    maximum keeps it sorted), so set sizes share compilations."""
    from . import nulls
    from .api import device_streams, get_decoder

    staged = _staged_set_u32(col.dtype, vals)
    if staged is None:
        return jnp.zeros((num_groups(col.n), LANES), jnp.uint32)
    m = staged.size
    key = (col.static_key(), "isin", m)
    fn = _FILTER_CACHE.get(key)
    if fn is None:
        ng = num_groups(col.n)
        decoder = get_decoder(col)

        def search(streams, table):
            u = decoder(streams).reshape(ng, SLOTS, LANES)
            pos = jnp.clip(jnp.searchsorted(table, u.reshape(-1)), 0, table.shape[0] - 1)
            hits = (table[pos] == u.reshape(-1)).reshape(ng, SLOTS, LANES).astype(jnp.uint32)
            i = jax.lax.broadcasted_iota(jnp.uint32, (1, SLOTS, 1), 1)
            return jnp.sum(hits << i, axis=1, dtype=jnp.uint32)

        fn = _FILTER_CACHE[key] = jax.jit(search)
    bm = fn(device_streams(col), jnp.asarray(staged))
    if nulls.is_nullable(col):
        bm = bm & nulls.valid_words_device(col)
    return bm


def _isin_searched_wide(col: EncodedColumn, values):
    """Membership for 64-bit (wide) columns: both 32-bit planes decode on
    device and each (hi, lo) pair binary-searches the staged set, sorted
    lexicographically — log2(m) branchless select steps, no int64 device
    arrays (the same plane-split discipline as _wide_filter_fn). Floats
    (float64) match in bitpattern space."""
    from . import nulls, wide
    from .api import device_streams, get_decoder

    staged = _staged_set_u64(col.dtype, values)
    if staged is None:
        return jnp.zeros((num_groups(col.n), LANES), jnp.uint32)
    slo, shi = staged
    m = slo.size
    key = (col.static_key(), "isin_wide", m)
    fn = _FILTER_CACHE.get(key)
    if fn is None:
        ng = num_groups(col.n)
        lo_col, hi_col = wide._sub(col, "lo"), wide._sub(col, "hi")
        dec_lo, dec_hi = get_decoder(lo_col), get_decoder(hi_col)

        def search(s_lo, s_hi, tlo, thi):
            lo = dec_lo(s_lo).reshape(-1)
            hi = dec_hi(s_hi).reshape(-1)
            pos = jnp.zeros(lo.shape, jnp.int32)
            step = m >> 1
            while step:  # static unroll: branchless lower-bound
                cand = pos + step
                chi, clo = thi[cand], tlo[cand]
                le = (chi < hi) | ((chi == hi) & (clo <= lo))
                pos = jnp.where(le, cand, pos)
                step >>= 1
            hit = (thi[pos] == hi) & (tlo[pos] == lo)
            hits = hit.reshape(ng, SLOTS, LANES).astype(jnp.uint32)
            i = jax.lax.broadcasted_iota(jnp.uint32, (1, SLOTS, 1), 1)
            return jnp.sum(hits << i, axis=1, dtype=jnp.uint32)

        fn = _FILTER_CACHE[key] = jax.jit(search)
    bm = fn(
        device_streams(wide._sub(col, "lo")),
        device_streams(wide._sub(col, "hi")),
        jnp.asarray(slo),
        jnp.asarray(shi),
    )
    if nulls.is_nullable(col):
        bm = bm & nulls.valid_words_device(col)
    return bm


def dict_mask_bitmap(col: EncodedColumn, mask: np.ndarray):
    """Bitmap of rows whose dictionary entry is set in ``mask`` (bool[d]) —
    dict/cascade/strdict columns. Contiguous-ish masks rewrite to ≤8 code
    range scans; fragmented masks run one jitted lookup-table pass over
    the decoded codes (the table is a runtime argument). The semi-join
    primitive."""
    from . import nulls
    from .groupby import _codes_device_column

    mask = np.asarray(mask, bool)
    d = col.params["dict_size"]
    if mask.shape != (d,):
        raise ValueError(f"mask must have shape ({d},), got {mask.shape}")
    inner = _codes_device_column(col)
    bounds = np.flatnonzero(np.diff(mask.astype(np.int8), prepend=0, append=0))
    ranges = list(zip(bounds[0::2].tolist(), bounds[1::2].tolist()))
    acc = None
    if len(ranges) <= 8:
        for s, e in ranges:
            bm = filter_bitmap(inner, "eq", s) if e - s == 1 else between_bitmap(inner, s, e - 1)
            acc = bm if acc is None else (acc | bm)
        if acc is None:
            acc = jnp.zeros((num_groups(col.n), LANES), jnp.uint32)
    else:
        from .api import device_streams, get_decoder

        key = (col.static_key(), "dictlut")
        fn = _FILTER_CACHE.get(key)
        if fn is None:
            ng = num_groups(col.n)
            decoder = get_decoder(inner)

            def lut(streams, table):
                codes = decoder(streams).reshape(ng, SLOTS, LANES)
                hits = table[codes].astype(jnp.uint32)
                i = jax.lax.broadcasted_iota(jnp.uint32, (1, SLOTS, 1), 1)
                return jnp.sum(hits << i, axis=1, dtype=jnp.uint32)

            fn = _FILTER_CACHE[key] = jax.jit(lut)
        acc = fn(device_streams(inner), jnp.asarray(mask.astype(np.uint32)))
    if nulls.is_nullable(col):
        acc = acc & nulls.valid_words_device(col)
    return acc


def filter_bitmap_cols(a: EncodedColumn, b: EncodedColumn, op: str) -> jax.Array:
    """Column-vs-column predicate: bitmap of ``a[i] <op> b[i]`` — both
    columns decode in ONE jitted program (XLA schedules them back-to-back
    on-chip) and only the 1-bit match words leave. Columns must share
    length and logical dtype (the comparison key mapping is per-dtype);
    wide columns are not supported — compare their planes via the caller."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {_OPS}, got {op!r}")
    if a.n != b.n:
        raise ValueError(f"length mismatch: {a.n} vs {b.n}")
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype} vs {b.dtype}")
    if "wide" in (a.scheme, b.scheme):
        raise NotImplementedError("column-vs-column compare of 64-bit columns")
    from .api import device_streams, get_decoder

    key = (a.static_key(), b.static_key(), "colcol", op)
    fn = _FILTER_CACHE.get(key)
    if fn is None:
        ng = num_groups(a.n)
        dt = np_dtype(a.dtype)
        kind, itemsize = dt.kind, dt.itemsize
        da, db = get_decoder(a), get_decoder(b)

        def both(sa, sb):
            ua = da(sa).reshape(ng, SLOTS, LANES)
            ub = db(sb).reshape(ng, SLOTS, LANES)
            # map BOTH sides through the same monotone key (sign-extend /
            # total order), then compare in key space
            ka = _key_space(ua, kind, itemsize)
            kb = _key_space(ub, kind, itemsize)
            hits = {
                "eq": ka == kb, "ne": ka != kb, "lt": ka < kb,
                "le": ka <= kb, "gt": ka > kb, "ge": ka >= kb,
            }[op].astype(jnp.uint32)
            i = jax.lax.broadcasted_iota(jnp.uint32, (1, SLOTS, 1), 1)
            return jnp.sum(hits << i, axis=1, dtype=jnp.uint32)

        fn = _FILTER_CACHE[key] = jax.jit(both)
    bm = fn(device_streams(a), device_streams(b))
    from . import nulls

    for c in (a, b):  # SQL: a row with either side NULL never matches
        if nulls.is_nullable(c):
            bm = bm & nulls.valid_words_device(c)
    return bm


def _key_space(v, kind: str, itemsize: int):
    """uint32 payloads -> comparable keys (int32 sign-extended for signed,
    total-order uint32 for floats, raw uint32 otherwise) — the two-operand
    twin of _cmp's one-sided mapping."""
    if kind == "i":
        v = jax.lax.bitcast_convert_type(v, jnp.int32)
        k = 32 - 8 * itemsize
        return (v << k) >> k if k else v
    if kind == "f":
        return _total_order_u32(v)
    return v


def count_where_cols(a: EncodedColumn, b: EncodedColumn, op: str) -> int:
    """Number of rows where ``a[i] <op> b[i]``."""
    return count_bits(filter_bitmap_cols(a, b, op), a.n)


def select(col: EncodedColumn, bitmap) -> np.ndarray:
    """Materialize the values at the bitmap's set positions — the SELECT
    half of a scan (bitmap from filter_bitmap over this or any other
    column of the same length). Only the groups containing matches
    decode (partial.take), so a selective predicate touches a fraction
    of the column's bytes."""
    from .partial import take
    from .ref.lmp import lmp_unpack

    words = np.asarray(bitmap).reshape(num_groups(col.n), LANES)
    mask = lmp_unpack(words, 1, col.n).astype(bool)
    return take(col, np.flatnonzero(mask))


def select_where(col: EncodedColumn, op: str, value) -> np.ndarray:
    """One-shot ``SELECT col WHERE col <op> value``."""
    return select(col, filter_bitmap(col, op, value))


def where_mask(col: EncodedColumn, op: str, value: int) -> np.ndarray:
    """Boolean mask of length n (host) — unpacked bitmap for verification
    and small results; big pipelines should consume the bitmap directly."""
    from .ref.lmp import lmp_unpack

    words = np.asarray(filter_bitmap(col, op, value))
    ng = num_groups(col.n)
    return lmp_unpack(words.reshape(ng, LANES), 1, col.n).astype(bool)
