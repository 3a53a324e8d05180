"""Host utility layer.

Equivalent of libgiddy's ``src/util/`` (integer.h exact-width
ints, math.hpp div_rounding_up/ilog2, endianness.h — per SURVEY.md §3.9;
upstream mount was empty, paths are recollected). Everything here is plain
Python/NumPy (the compile-cache helper imports JAX when called);
device-side helpers live in ``giddy_tpu.kernels.lanes``.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

# Fundamental layout constants (FORMAT.md §0). Frozen by the format spec.
LANES = 1024  # interleave lanes C
SLOTS = 32  # values per lane per group S
GROUP = LANES * SLOTS  # 32768 — the independently-decodable tile
WORD_BITS = 32

U32 = np.uint32
I32 = np.int32

_DTYPES = {
    "int32": np.int32,
    "uint32": np.uint32,
    "int64": np.int64,
    "uint64": np.uint64,
    "int16": np.int16,
    "uint16": np.uint16,
    "int8": np.int8,
    "uint8": np.uint8,
    # Floats ride as IEEE-754 bitpatterns: encode/decode bitcast through
    # uint32 payloads (lossless, NaN-preserving); float64 splits into
    # planes via the wide wrapper. Magnitude-based schemes (nbit/for/
    # delta/model) see the bitpattern as an integer — roundtrip-exact,
    # compression depends on the data; dict/rle/raw behave as usual.
    "float32": np.float32,
    "float64": np.float64,
}


def np_dtype(name: str) -> np.dtype:
    return np.dtype(_DTYPES[name])


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def is_power_of_2(x: int) -> bool:
    return x > 0 and (x & (x - 1)) == 0


def next_power_of_2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def ilog2(x: int) -> int:
    if not is_power_of_2(x):
        raise ValueError(f"{x} is not a power of two")
    return x.bit_length() - 1


def bits_needed(max_value: int) -> int:
    """Smallest B with max_value < 2**B (B>=1); the NBit width chooser."""
    return max(1, int(max_value).bit_length())


def bytes_needed(max_value: int) -> int:
    return max(1, cdiv(bits_needed(max_value), 8))


def num_groups(n: int) -> int:
    return cdiv(max(n, 1), GROUP)


# Device positions/iotas are int32 (JAX runs without 64-bit mode): a single
# device decode call addresses at most 2**31 padded elements. Larger
# columns go through partial/stream (group slices) — the libgiddy
# ``IndexSize`` analog is chunking, not wider device indices.
MAX_DEVICE_ELEMS = 2**31


NP_CMP = {
    "eq": np.equal, "ne": np.not_equal, "lt": np.less,
    "le": np.less_equal, "gt": np.greater, "ge": np.greater_equal,
}


def check_device_addressable(n: int, what: str = "decode") -> None:
    # strict: n_pad == 2**31 itself is excluded — RLE padding sentinels sit
    # at n_pad and must stay representable (and sorted) as int32
    if num_groups(n) * GROUP >= MAX_DEVICE_ELEMS:
        raise NotImplementedError(
            f"{what} of {n} elements exceeds the 2**31 single-call device "
            "addressing limit (int32 positions); use partial.decode_groups "
            "or stream.stream_decode to process the column in group chunks"
        )


def sorted_factorize(values: np.ndarray):
    """(sorted_unique, codes) — np.unique(return_inverse=True) semantics
    via pandas' hash-based factorize: O(n + d log d) instead of a full
    O(n log n) sort, which is ~100x faster when d << n (measured 0.5 s vs
    96 s on a 67M-value dictionary column). use_na_sentinel=False keeps
    NA-like values (NaN/None) as real dictionary entries, matching
    np.unique exactly. Falls back to np.unique when pandas is
    unavailable."""
    try:
        import pandas as pd

        codes, uniq = pd.factorize(values, sort=True, use_na_sentinel=False)
        return uniq, codes
    except Exception:
        return np.unique(values, return_inverse=True)


def pad_to_groups(v: np.ndarray, fill: int = 0) -> np.ndarray:
    """Pad a 1-D value array to a whole number of GROUPs (FORMAT.md §0)."""
    n = v.shape[0]
    n_pad = num_groups(n) * GROUP
    if n == n_pad:
        return np.ascontiguousarray(v)
    out = np.full(n_pad, fill, dtype=v.dtype)
    out[:n] = v
    return out


def dtype_to_u32(v: np.ndarray) -> np.ndarray:
    """Reinterpret a logical-dtype array as uint32 payloads (zero-extended).

    32-bit dtypes are bit-reinterpreted; narrower dtypes are zero-extended
    via their unsigned view. 64-bit columns are not LMP-packable directly
    (split into planes or use dzbv).
    """
    dt = v.dtype
    if dt.itemsize == 4:
        return v.view(np.uint32)
    if dt.itemsize > 4:
        raise ValueError(f"{dt} too wide for 32-bit LMP packing")
    return v.view(np.dtype(f"uint{dt.itemsize * 8}")).astype(np.uint32)


def u32_to_dtype(u: np.ndarray, dtype_name: str) -> np.ndarray:
    """Inverse of :func:`dtype_to_u32`: uint32 payloads -> logical dtype."""
    dt = np_dtype(dtype_name)
    if dt.itemsize == 4:
        return u.view(dt)
    if dt.itemsize > 4:
        raise ValueError(f"{dt} too wide for 32-bit LMP payloads")
    return u.astype(np.dtype(f"uint{dt.itemsize * 8}")).view(dt)


def zigzag(d: np.ndarray) -> np.ndarray:
    """Signed int32 -> unsigned zigzag (FORMAT.md §0.2)."""
    d = d.astype(np.int32, copy=False)
    if d.ndim == 1:
        from . import native

        nat = native.zigzag(d)
        if nat is not None:
            return nat
    return ((d.astype(np.uint32) << U32(1)) ^ (d >> 31).astype(np.uint32)).astype(
        np.uint32
    )


def unzigzag(z: np.ndarray) -> np.ndarray:
    """Unsigned zigzag -> signed int32 (FORMAT.md §0.2)."""
    z = z.astype(np.uint32, copy=False)
    if z.ndim == 1:
        from . import native

        nat = native.unzigzag(z)
        if nat is not None:
            return nat
    return ((z >> U32(1)) ^ (-(z & U32(1)).astype(np.int32)).astype(np.uint32)).astype(
        np.int32
    )


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here. Otherwise the cache lives at the fixed
    path ``<checkout>/.jax_cache`` (git-ignored), never one built from a
    temp name, a pid or the time, so a later run in the same checkout
    finds what an earlier one compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = str(pathlib.Path(__file__).resolve().parent.parent / ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

