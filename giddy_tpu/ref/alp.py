"""ALP-style lossless decimal-float compression — CPU reference codec
(FORMAT.md §1.16).

Beyond-parity scheme (libgiddy has no float-specific codec beyond treating
bitpatterns as ints — SURVEY.md §3.1 note): real float32 columns are
overwhelmingly *decimals* (prices, rates, measurements), i.e. the nearest
float to ``d / 10^e`` for a small integer ``d``. Following the ALP idea
(Afroozeh & Boncz 2023, PAPERS.md; format re-designed for the LMP/GROUP
layout AND for cross-platform bit-exactness), encode stores that integer
plus a tiny per-element ulp correction:

- pick one column exponent ``e`` in [0, 10] (smallest total cost);
- ``enc = rint(v * 10^e)`` in float64 (exact for |enc| < 2^23), stored
  FOR-style (per-GROUP min refs + LMP-packed offsets — decimals cluster);
- the device-reproducible approximation is ``m = f32(enc) * f32(10^-e)``
  — int→f32 convert and f32 multiply are single correctly-rounded IEEE
  ops, bit-identical on the host and the device. TRUE division would
  round-trip decimals exactly, but device f32 division need not be
  correctly rounded (reciprocal-based division disagrees by one ulp), so
  the decode must not divide;
- ``m`` is within ~1 ulp of ``v`` for decimal data, so the *bitpattern
  difference* ``corr = bits(v) - bits(m)`` is tiny (measured: zigzag fits
  2 bits with zero exceptions on price-like data). It ships as an
  LMP(corr_bits) side stream and decode is ``bits(m) + corr`` — integer
  wrap arithmetic, exact by construction on any platform;
- whatever still fails (NaN/Inf, |enc| >= 2^23, subnormals, -0.0,
  corrections beyond the 99.5%-quantile width) becomes an exception:
  position + original-bitpattern side streams scattered after the main
  decode, exactly the patched mechanism of FORMAT §1.11.
"""

from __future__ import annotations

import numpy as np

from .. import registry
from ..format import EncodedColumn
from ..util import GROUP, bits_needed, num_groups, pad_to_groups, unzigzag, zigzag
from .lmp import lmp_pack, lmp_unpack

E_MAX = 10  # 10^10 is exactly representable in f32; enc < 2^23 binds first
CORR_COVER = 0.995  # corr width covers this fraction; the tail is patched
CORR_MAX = 24  # widest useful correction: past this, patch the value


def _approx_bits(enc: np.ndarray, e: int) -> np.ndarray:
    """int32 bitpatterns of the device-reproducible approximation
    ``f32(enc) * f32(10^-e)`` (both ops single-rounded IEEE f32)."""
    m = enc.astype(np.float32) * np.float32(10.0**-e)
    return m.view(np.int32)


def _analyze(v: np.ndarray, e: int):
    """(enc int64, zig uint32, ok_range bool) for exponent ``e``."""
    with np.errstate(invalid="ignore", over="ignore"):
        encf = np.rint(v.astype(np.float64) * 10.0**e)
        # range-check on the FLOAT value before any int cast: casting huge
        # finite floats to int64 is C-undefined (differs across
        # architectures — an on-disk determinism hazard)
        ok = np.isfinite(encf) & (np.abs(encf) < 2**23)
        enc = np.where(ok, encf, 0.0).astype(np.int64)
    u = v.view(np.uint32)
    # subnormal v: the approximation may land subnormal too, and device
    # FTZ units disagree with the host there — always exceptions (they
    # are vanishingly rare in decimal data)
    subnormal = ((u & 0x7F800000) == 0) & ((u & 0x007FFFFF) != 0)
    ok &= ~subnormal
    corr = np.where(ok, u.view(np.int32) - _approx_bits(enc.astype(np.int32), e), 0)
    return enc, zigzag(corr.astype(np.int32)), ok


def _candidate(v: np.ndarray, n_eff: int, cand: int):
    """Full analysis of exponent ``cand`` over a group-padded array ``v``
    (n_eff = un-padded element count, for the exception-cost term).
    Returns (cost, cand, ok, offs, refs, bits, zig, corr_bits)."""
    ng = v.shape[0] // GROUP
    enc, zig, okr = _analyze(v, cand)
    # correction width: cover CORR_COVER of the plausibly-coverable
    # in-range values; the zig tail joins the exceptions (patched),
    # like ref/patch._pick_bits. Uncoverable corrections (-0.0's
    # 2^32-1, sign flips) are excluded from the quantile — they must
    # not drag corr_bits toward 32 (beyond CORR_MAX the stream costs
    # more than the 8-byte exception it avoids, and a 32-bit shift of
    # a uint32 is C-undefined).
    cov = okr & (zig < np.uint32(1) << np.uint32(CORR_MAX))
    zr = zig[cov] if cov.any() else np.zeros(1, np.uint32)
    q = int(np.quantile(zr.astype(np.float64), CORR_COVER, method="lower"))
    corr_bits = min(bits_needed(q), CORR_MAX)
    ok = okr & (zig.astype(np.int64) < (1 << corr_bits))
    ex = int((~ok[:n_eff]).sum())
    # benign stand-in for exceptions: the group's min of ok values
    # (keeps offsets narrow); all-exception groups fall back to 0
    gmin = np.where(ok, enc, np.int64(2**62)).reshape(ng, GROUP).min(axis=1)
    gmin = np.where(gmin == 2**62, 0, gmin)
    encf = np.where(ok, enc, np.repeat(gmin, GROUP))
    refs = encf.reshape(ng, GROUP).min(axis=1)
    offs = (encf - np.repeat(refs, GROUP)).astype(np.uint32)
    bits = bits_needed(int(offs.max(initial=0)))
    cost = ng * GROUP * (bits + corr_bits) / 8 + ex * 8 + ng * 4
    return (cost, cand, ok, offs, refs, bits, np.where(ok, zig, 0), corr_bits)


# Above this many groups, the exponent search runs on an evenly-strided
# group sample instead of 11 full-column analyses (the full column still
# gets ONE exact analysis pass with the winner — sampling only steers the
# e choice; exceptions keep every choice lossless). 16 groups keeps the
# small-column path byte-identical (golden digests).
SAMPLE_GROUPS = 16


def encode(
    values: np.ndarray,
    *,
    e: int | None = None,
    name: str = "col",
) -> EncodedColumn:
    values = np.asarray(values)
    if values.dtype != np.float32:
        raise ValueError(f"alp encodes float32 columns, got {values.dtype}")
    n = values.shape[0]
    u = values.view(np.uint32)
    fill = int(u[-1]) if n else 0  # last-value pad keeps group refs sane
    v = pad_to_groups(u, fill=fill).view(np.float32)
    ng = num_groups(n)

    if e is not None:
        cands = [e]
    elif ng > SAMPLE_GROUPS:
        idx = np.unique(np.linspace(0, ng - 1, SAMPLE_GROUPS).astype(np.int64))
        vs = v.reshape(ng, GROUP)[idx].reshape(-1)
        # the linspace endpoint always samples the tail group, whose pad
        # fill must not count as real elements in the exception-cost term;
        # pads sit at the end of the sample (idx ascending, last = ng-1)
        n_eff = vs.shape[0] - (ng * GROUP - n)
        scored = [_candidate(vs, n_eff, c)[:2] for c in range(E_MAX + 1)]
        cands = [min(scored)[1]]
    else:
        cands = range(E_MAX + 1)
    best = min(_candidate(v, n, cand) for cand in cands)
    _, exp_e, ok, offs, refs, bits, zig, corr_bits = best
    pos = np.nonzero(~ok[:n])[0].astype(np.int32)
    patch_val = u[pos.astype(np.int64)].view(np.int32)
    return EncodedColumn(
        name=name,
        scheme="alp",
        dtype="float32",
        n=n,
        params={
            "bits": int(bits),
            "corr_bits": int(corr_bits),
            "exp_e": int(exp_e),
            "count": int(pos.shape[0]),
        },
        streams={
            "packed": lmp_pack(offs, bits),
            "corr": lmp_pack(zig.astype(np.uint32), corr_bits),
            "refs": refs.astype(np.uint32).astype(np.int32),
            "patch_pos": pos,
            "patch_val": patch_val,
        },
    )


def decode(col: EncodedColumn) -> np.ndarray:
    p = col.params
    offs = lmp_unpack(col.streams["packed"], p["bits"], col.n)
    zig = lmp_unpack(col.streams["corr"], p["corr_bits"], col.n)
    refs = col.streams["refs"].view(np.uint32)
    gidx = np.arange(col.n, dtype=np.int64) // GROUP
    enc = (refs[gidx] + offs).astype(np.uint32).view(np.int32)
    out = _approx_bits(enc, p["exp_e"]).view(np.uint32)
    out = (out + unzigzag(zig).view(np.uint32)).copy()  # wrap add
    pos = col.streams["patch_pos"].astype(np.int64)
    out[pos] = col.streams["patch_val"].view(np.uint32)
    return out.view(np.float32)


registry.register("alp", encode, decode)
