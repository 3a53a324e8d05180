"""Scheme advisor: pick the best scheme for a column by measuring.

The reference leaves scheme choice to its DBMS caller (MonetDB decided
per column — SURVEY.md §1); a standalone framework needs the capability
in-house. Strategy: trial-encode a sample (or the whole column) with every
candidate and rank by compressed size; ties break toward cheaper decode.
"""

from __future__ import annotations

import numpy as np

from . import registry
from .format import EncodedColumn
from .util import GROUP

# Candidates in decode-cost order (cheapest first — the tiebreaker).
CANDIDATES = ["rle", "dict", "cascade", "bitmap", "nbit", "dzbf", "for", "delta", "delta2", "alp", "xordelta", "model", "dzbv", "patched"]


def suggest(
    values: np.ndarray,
    *,
    candidates: list[str] | None = None,
    sample_groups: int = 4,
    rng: np.random.Generator | None = None,
    measure: bool = False,
    tie_tol: float = 0.10,
) -> list[tuple[str, float]]:
    """Rank candidate schemes by estimated compression ratio on a sample.

    Returns [(scheme, estimated_ratio)] best-first; schemes that cannot
    encode the column (e.g. bitmap over a high-cardinality column would
    explode) are skipped. The sample is ONE contiguous whole-GROUP window:
    scattered groups would create artificial jumps at the seams, and a
    single outlier delta poisons a global-width scheme's estimate (delta
    on a sorted column looked 4x worse than reality). Contiguity keeps
    delta/run statistics exact; the cost is missing long-range dictionary
    growth, which only under-counts dict's size (small anyway).

    With ``measure=True``, candidates whose ratios are within ``tie_tol``
    of the leader are re-ordered by measured device decode throughput on
    the sample (compiles each tied candidate's decoder once — spends
    seconds of compile time to settle ties with data instead of the static
    decode-cost ordering). Leave off where device timings are unreliable.
    """
    values = np.asarray(values)
    n = values.shape[0]
    cands = candidates or CANDIDATES
    if n > sample_groups * GROUP:
        rng = rng or np.random.default_rng(0)
        ng = n // GROUP
        g0 = int(rng.integers(0, ng - sample_groups + 1))
        sample = values[g0 * GROUP : (g0 + sample_groups) * GROUP]
    else:
        sample = values
    results = []
    for scheme in cands:
        if scheme == "bitmap" and np.unique(sample).size > 64:
            continue  # decode cost explodes with cardinality
        try:
            col = registry.get(scheme).encode(sample, name="_advise")
        except Exception:
            continue
        results.append((scheme, col.nbytes_decoded / max(col.nbytes_compressed, 1)))
    results.sort(key=lambda t: (-t[1], CANDIDATES.index(t[0]) if t[0] in CANDIDATES else 99))
    if measure and len(results) > 1:
        k = 1
        while k < len(results) and results[k][1] >= results[0][1] * (1 - tie_tol):
            k += 1
        if k > 1:
            gbps = {s: _measure_decode_gbps(sample, s) for s, _ in results[:k]}
            results[:k] = sorted(results[:k], key=lambda t: -gbps[t[0]])
    return results


def _measure_decode_gbps(
    sample: np.ndarray, scheme: str, *, iters: int = 5, target_groups: int = 64
) -> float:
    """Device decode throughput (decoded GB/s) of `scheme` on the sample,
    tiled to ~target_groups GROUPs so the measurement rises above dispatch
    latency. A scheme that fails to compile or decode raises."""
    import time

    from .api import device_streams, get_decoder

    tiled = np.tile(sample, max(1, (target_groups * GROUP) // max(sample.shape[0], 1)))
    col = registry.get(scheme).encode(tiled, name="_measure")
    fn = get_decoder(col)
    st = device_streams(col)
    fn(st).block_until_ready()  # compile + warm
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(st)
    out.block_until_ready()
    dt = (time.perf_counter() - t0) / iters
    return col.nbytes_decoded / max(dt, 1e-9) / 1e9


def encode_best(
    values: np.ndarray, *, name: str = "col", ranked: list[tuple[str, float]] | None = None, **kw
) -> EncodedColumn:
    """Encode with the advisor's top pick (falls back to raw if nothing
    beats 1.0x). Pass a precomputed ``ranked`` list (from suggest) to avoid
    re-running the trial encodes."""
    if ranked is None:
        ranked = suggest(values, **kw)
    best = ranked[0] if ranked and ranked[0][1] > 1.0 else ("raw", 1.0)
    return registry.get(best[0]).encode(np.asarray(values), name=name)
