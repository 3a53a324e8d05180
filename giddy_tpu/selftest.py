"""``python -m giddy_tpu.selftest`` — one-shot device-vs-oracle proof.

Decodes every registered scheme on whatever backend is present, compares
bit-exactly against the CPU oracle, runs the structural HBM-traffic audit
(roofline.traffic_audit), and prints ONE JSON line. chip_smoke.py runs it
on the GPU at 2**24 + 999 elements per column; bench.py runs it after a
bench run, and the JSON lands in ``results/selftest.json``.

Exit code 0 = every scheme exact; 1 = any mismatch or error.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

from giddy_tpu.datagen import CORE_SCHEMES as SCHEMES  # single source of truth
# Structural single-pass ceiling: traffic / (compressed + decoded) near
# 1.0 (a ratio r caps physical SoL at 1/r; BASELINE's >=80% target needs
# r <= 1.25). Reported as ``traffic_ok``; whether to gate on it is the
# caller's choice.
TRAFFIC_CAP = 1.15


def run_selftest(n: int, seed: int = 0, audit: bool = True) -> dict:
    import jax

    import giddy_tpu as gt
    from giddy_tpu.datagen import gen_column
    from giddy_tpu.roofline import traffic_audit

    rng = np.random.default_rng(seed)
    report: dict = {
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "n": n,
        "schemes": {},
    }
    ok = True
    for scheme in SCHEMES:
        entry: dict = {}
        try:
            v = gen_column(scheme, n, rng)
            col = gt.encode(v, scheme, name=f"selftest_{scheme}")
            t0 = time.perf_counter()
            out = np.asarray(gt.decode(col))
            entry["decode_s"] = round(time.perf_counter() - t0, 3)
            ref = gt.decode_ref(col)
            entry["exact"] = bool((out == ref).all())
            if audit:
                a = traffic_audit(col)
                entry["temp_bytes"] = a["temp_bytes"]
                entry["traffic_vs_ideal"] = round(a["ratio"], 4)
                entry["traffic_vs_sol"] = round(a["sol_ratio"], 4)
        except Exception as e:  # pragma: no cover - surfaced in the JSON
            entry["error"] = f"{type(e).__name__}: {e}"
            entry["exact"] = False
        ok = ok and entry.get("exact", False)
        report["schemes"][scheme] = entry
        print(f"[selftest] {scheme:9s} "
              + ("EXACT" if entry.get("exact") else f"FAIL {entry.get('error', '')}"),
              file=sys.stderr)
    # composite surfaces: 64-bit planes, string dictionaries, nullable
    # columns, and the one-program mixed container — the wrappers around
    # the core kernels that a migrating user actually calls
    for name, fn in (
        ("wide", _check_wide),
        ("strdict", _check_strdict),
        ("nullable", _check_nullable),
        ("mixed_container", _check_mixed),
        ("rle_dense", _check_rle_dense),
        ("big_dict", _check_big_dict),
        ("narrow_store", _check_narrow_store),
        ("xor_narrow", _check_xor_narrow),
        # query layer: the fused filter/fold programs compile separately
        # from the decoders
        ("query_filters", _check_query_filters),
        ("query_aggregates", _check_aggregates),
        ("query_groupby", _check_groupby),
        ("query_topk", _check_topk),
        ("query_join", _check_join),
        ("query_zonemap", _check_zonemap),
        ("query_dataset", _check_dataset),
    ):
        entry = {}
        try:
            fn(n, rng)
            entry["exact"] = True
        except Exception as e:  # pragma: no cover - surfaced in the JSON
            entry["error"] = f"{type(e).__name__}: {e}"
            entry["exact"] = False
        ok = ok and entry["exact"]
        report["schemes"][name] = entry
        print(f"[selftest] {name:15s} "
              + ("EXACT" if entry["exact"] else f"FAIL {entry.get('error', '')}"),
              file=sys.stderr)
    # drift guard: every registered device-decodable scheme must be covered
    # here (core matrix or a composite check) — a new scheme that escapes
    # the hardware selftest defeats its purpose
    from giddy_tpu import registry

    covered = set(SCHEMES) | {"wide", "strdict"}
    uncovered = [
        s for s in registry.schemes()
        if registry.get(s).decode_device is not None and s not in covered
    ]
    if uncovered:
        report["uncovered_schemes"] = uncovered
        print(f"[selftest] UNCOVERED registered schemes: {uncovered}", file=sys.stderr)
        ok = False
    report["pass"] = ok
    if audit:
        bad = {
            s: e["traffic_vs_sol"]
            for s, e in report["schemes"].items()
            if "traffic_vs_sol" in e and e["traffic_vs_sol"] > TRAFFIC_CAP
        }
        report["traffic_ok"] = not bad
        if bad:
            print(f"[selftest] traffic over {TRAFFIC_CAP}x SoL bytes: {bad}", file=sys.stderr)
    return report


def _check_wide(n, rng):
    import giddy_tpu as gt

    v = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    out = np.asarray(gt.decode(gt.encode(v, "wide")))
    assert (out == v).all()


def _check_strdict(n, rng):
    import giddy_tpu as gt
    from giddy_tpu import strings

    vocab = [f"name_{i}".encode() for i in range(97)]
    vals = [vocab[i] for i in rng.integers(0, len(vocab), n)]
    col = strings.encode_strings(vals, name="st")
    out = strings.decode(col)
    assert list(out) == vals


def _check_nullable(n, rng):
    import giddy_tpu as gt
    from giddy_tpu import nulls

    v = rng.integers(0, 1000, n, dtype=np.int64).astype(np.int32)
    mask = rng.random(n) >= 0.1
    col = gt.encode(v, "nbit", valid=mask)
    assert nulls.null_count(col) == int((~mask).sum())
    out = np.asarray(gt.decode(col))
    assert (out[mask] == v[mask]).all()


def _check_mixed(n, rng):
    import giddy_tpu as gt
    from giddy_tpu.datagen import gen_column

    cols = [
        gt.encode(gen_column(s, n // 2, rng), s, name=f"mix_{s}")
        for s in ("delta", "dict", "rle", "patched")
    ]
    outs = gt.decode_columns(cols)
    for c in cols:
        assert (np.asarray(outs[c.name]) == gt.decode_ref(c)).all(), c.name


def _check_big_dict(n, rng):
    """A 16k-entry dictionary (strdict's realistic regime): the take over
    a table far larger than the core matrix's 40-entry dictionary."""
    import giddy_tpu as gt

    d = 16384
    vocab = rng.integers(-(2**31), 2**31 - 1, d, dtype=np.int64).astype(np.int32)
    v = vocab[rng.integers(0, d, n)]
    col = gt.encode(v, "dict")
    assert col.params["dict_size"] > 2048, "want a large dictionary"
    out = np.asarray(gt.decode(col))
    assert (out == v).all(), "big dict"


def _check_rle_dense(n, rng):
    """Mid-density runs (length ~4-12): thousands of runs per group, the
    deepest run-table search, incl. cascade(rle)'s dictionary take."""
    import giddy_tpu as gt

    for rl in (5, 12):
        v = (np.arange(n, dtype=np.int64) // rl).astype(np.int32) % 50000
        out = np.asarray(gt.decode(gt.encode(v, "rle")))
        assert (out == v).all(), f"rle run-length {rl}"
    base = (np.arange(n // 8, dtype=np.int64) % 900).astype(np.int32)
    v = np.repeat(base, 8)[:n]
    col = gt.encode(v, "cascade", codes_scheme="rle")
    out = np.asarray(gt.decode(col))
    assert (out == v).all(), "cascade(rle)"


def _check_narrow_store(n, rng):
    """Storage-width materialization: int8/int16 columns decode with narrow
    stores — the compiled output buffer must be 1/2 bytes per element and
    the values bit-exact."""
    import giddy_tpu as gt
    from giddy_tpu import api
    from giddy_tpu.roofline import traffic_audit
    from giddy_tpu.util import GROUP

    cases = [
        ("nbit", rng.integers(0, 200, n).astype(np.uint8)),
        ("for", rng.integers(0, 60000, n).astype(np.uint16)),
        ("delta", np.minimum(np.arange(n) // 600, 100).astype(np.int16)),
        ("dict", rng.integers(-100, 100, n).astype(np.int8)),
        ("rle", (np.arange(n) // 700).astype(np.int16)),
        # mid-density runs combined with the narrow store
        ("rle", ((np.arange(n) // 5) % 30000).astype(np.int16)),
        ("dzbv", rng.integers(0, 60000, n).astype(np.uint16)),
        ("bitmap", (rng.integers(0, 4, n) * 7).astype(np.uint8)),
        ("patched", np.where(rng.random(n) < 0.002, 30000, rng.integers(0, 60, n)).astype(np.int16)),
    ]
    for scheme, v in cases:
        col = gt.encode(v, scheme)
        assert api.narrow_store_dtype(col) is not None, scheme
        out = np.asarray(gt.decode(col))
        assert out.dtype == v.dtype and (out == v).all(), f"narrow {scheme}"
        a = traffic_audit(col)
        ng = -(-n // GROUP)
        assert a["out_bytes"] == ng * GROUP * v.dtype.itemsize, (scheme, a)
    base = (np.arange(n // 8, dtype=np.int64) % 90).astype(np.int16)
    v = np.repeat(base, 8)[:n]
    out = np.asarray(gt.decode(gt.encode(v, "cascade", codes_scheme="rle")))
    assert out.dtype == v.dtype and (out == v).all(), "narrow cascade"
    # more groups than an int8 tile row count, whatever n the caller picked
    nb = 40 * GROUP + 13
    vb = rng.integers(0, 200, nb).astype(np.uint8)
    colb = gt.encode(vb, "nbit")
    outb = np.asarray(gt.decode(colb))
    assert outb.dtype == vb.dtype and (outb == vb).all(), "narrow multi-block"
    ab = traffic_audit(colb)
    assert ab["out_bytes"] == 41 * GROUP, ("narrow multi-group store", ab)


def _check_xor_narrow(n, rng):
    """A narrow (<= 4-bit) XOR stream; the core xordelta column covers the
    wide one."""
    import giddy_tpu as gt

    v = (np.cumsum(rng.integers(0, 3, n)) % 7).astype(np.int32).view(np.float32)
    col = gt.encode(v, "xordelta")
    assert col.params["bits"] <= 4, col.params
    out = np.asarray(gt.decode(col))
    assert (out.view(np.uint32) == v.view(np.uint32)).all()


def _check_query_filters(n, rng):
    """Fused decode+compare bitmaps: every op x {int32 delta, float32 alp,
    int16 nbit} + select_where materialization + isin, vs NumPy."""
    import giddy_tpu as gt
    from giddy_tpu import query

    import operator

    np_op = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
             "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}
    vi = np.cumsum(rng.integers(-3, 4, n)).astype(np.int32)
    vf = (rng.integers(0, 2000, n) / 100.0).astype(np.float32)
    vn = rng.integers(-300, 300, n).astype(np.int16)
    for v, scheme in ((vi, "delta"), (vf, "alp"), (vn, "nbit")):
        col = gt.encode(v, scheme)
        pivot = v[n // 2]
        for op in ("lt", "le", "gt", "ge", "eq", "ne"):
            got = query.count_where(col, op, pivot)
            want = int(np_op[op](v, pivot).sum())
            assert got == want, (scheme, op, got, want)
    col = gt.encode(vi, "delta")
    pivot = int(vi[n // 3])
    sel = query.select_where(col, "ge", pivot)
    assert (sel == vi[vi >= pivot]).all()
    vals = [int(vi[1]), int(vi[7]), 10**9]
    want = int(np.isin(vi, vals).sum())
    got = query.count_bits(query.isin_bitmap(col, vals), n)
    assert got == want, ("isin", got, want)


def _check_aggregates(n, rng):
    """Fused fold kernels: exact sum/min/max/avg/distinct on int32, int16
    and float32 columns vs NumPy."""
    import giddy_tpu as gt
    from giddy_tpu import aggregate as ag

    import math

    vi = rng.integers(-(10**6), 10**6, n).astype(np.int32)
    vf = (rng.standard_normal(n) * 100).astype(np.float32)
    vn = rng.integers(0, 500, n).astype(np.int16)
    for v, scheme in ((vi, "nbit"), (vf, "xordelta"), (vn, "for")):
        col = gt.encode(v, scheme)
        s = ag.sum_(col)
        if v.dtype.kind == "f":
            assert math.isclose(s, float(np.sum(v, dtype=np.float64)), rel_tol=1e-9), scheme
        else:
            assert s == int(v.astype(np.int64).sum()), scheme
        assert ag.min_(col) == v.min() and ag.max_(col) == v.max(), scheme
    col = gt.encode(vn, "dict")
    assert ag.distinct_count(col) == len(np.unique(vn))


def _check_groupby(n, rng):
    """Per-key count/sum/min/max folds (dict keys), plain and under a
    filter bitmap, vs NumPy."""
    import giddy_tpu as gt
    from giddy_tpu import groupby as gb, query

    keys = rng.integers(0, 37, n).astype(np.int32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    kcol = gt.encode(keys, "dict")
    vcol = gt.encode(vals, "nbit")
    r = gb.group_reduce(kcol, vcol, aggs=("count", "sum", "min", "max"))
    for i, k in enumerate(np.asarray(r.keys)):
        m = keys == int(k)
        assert int(np.asarray(r.count)[i]) == int(m.sum()), k
        assert int(np.asarray(r.sum)[i]) == int(vals[m].astype(np.int64).sum()), k
        assert int(np.asarray(r.min)[i]) == int(vals[m].min()), k
        assert int(np.asarray(r.max)[i]) == int(vals[m].max()), k
    bm = query.filter_bitmap(vcol, "ge", 0)
    r2 = gb.group_reduce(kcol, vcol, aggs=("count",), bitmap=bm)
    m0 = vals >= 0
    for i, k in enumerate(np.asarray(r2.keys)):
        assert int(np.asarray(r2.count)[i]) == int((m0 & (keys == int(k))).sum())


def _check_topk(n, rng):
    """One-jit decode -> monotone keys -> lax.top_k, largest and smallest,
    plus argmax, vs NumPy."""
    import giddy_tpu as gt
    from giddy_tpu import topk

    v = rng.integers(-(10**8), 10**8, n).astype(np.int32)
    col = gt.encode(v, "nbit")
    tv, tp = topk.top_k(col, 5)
    want = np.sort(v)[::-1][:5]
    assert (np.asarray(tv) == want).all(), (tv, want)
    assert (v[np.asarray(tp)] == want).all()
    sv, _ = topk.top_k(col, 5, largest=False)
    assert (np.asarray(sv) == np.sort(v)[:5]).all()
    assert v[topk.argmax_(col)] == v.max()


def _check_join(n, rng):
    """Device membership scans + host sort-merge equi-join vs a NumPy
    reference join."""
    import giddy_tpu as gt
    from giddy_tpu import join

    left = rng.integers(0, n // 2, n).astype(np.int32)
    right = rng.integers(n // 4, n, n // 3).astype(np.int32)
    li, ri = join.join_indices(gt.encode(left, "nbit"), gt.encode(right, "nbit"))
    li, ri = np.asarray(li), np.asarray(ri)
    assert (left[li] == right[ri]).all()
    common = np.intersect1d(left, right)
    lc = np.bincount(left[np.isin(left, common)], minlength=n)
    rc = np.bincount(right[np.isin(right, common)], minlength=n)
    assert li.shape[0] == int((lc.astype(np.int64) * rc.astype(np.int64)).sum())


def _check_zonemap(n, rng):
    """Zone-map pruned count on clustered data vs NumPy (exercises the
    partial group-by-group decode of undecided groups)."""
    import giddy_tpu as gt
    from giddy_tpu import zonemap

    v = (np.arange(n, dtype=np.int64) // 977 * 10).astype(np.int32)
    v += rng.integers(0, 10, n).astype(np.int32)
    col = gt.encode(v, "delta")
    pivot = int(v[n // 3])
    assert zonemap.count_where_pruned(col, "lt", pivot) == int((v < pivot).sum())


def _check_dataset(n, rng):
    """Partitioned-dataset scan: manifest pruning + per-partition decode,
    count/agg/groupby over two partitions, vs NumPy."""
    import shutil
    import tempfile

    from giddy_tpu.dataset import Dataset
    from giddy_tpu.table import Table

    k1 = rng.integers(0, 9, n).astype(np.int32)
    x1 = rng.integers(0, 1000, n).astype(np.int32)
    k2 = rng.integers(0, 9, n).astype(np.int32)
    x2 = rng.integers(5000, 9000, n).astype(np.int32)
    t1 = Table.from_arrays({"k": k1, "x": x1}, schemes={"k": "dict"})
    t2 = Table.from_arrays({"k": k2, "x": x2}, schemes={"k": "dict"})
    d = tempfile.mkdtemp(prefix="gt_selftest_ds_")
    try:
        ds = Dataset.write(d + "/ds", [t1, t2])
        assert ds.count(("x", "ge", 5000)) == int((x1 >= 5000).sum() + (x2 >= 5000).sum())
        assert ds.agg("x", "min") == int(min(x1.min(), x2.min()))
        assert ds.agg("x", "max") == int(max(x1.max(), x2.max()))
        g = ds.groupby("k", "x", aggs=("sum",))
        allk = np.concatenate([k1, k2])
        allx = np.concatenate([x1, x2]).astype(np.int64)
        for k, s in zip(np.asarray(g.keys), np.asarray(g.sum)):
            assert int(s) == int(allx[allk == int(k)].sum()), k
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=(1 << 22) + 999,
                    help="elements per column (default ~4.2M: 129 groups "
                    "with a ragged tail)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-audit", action="store_true")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    report = run_selftest(args.n, args.seed, audit=not args.no_audit)
    line = json.dumps(report)
    print(line)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line)
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
