"""Sharded-decode checks, run on an 8-virtual-device CPU mesh.

Executed as a subprocess by test_dist.py (the main pytest process may hold
a GPU backend; the multi-host code path needs 8 devices — SURVEY.md
§5.2.3). Exits nonzero on any mismatch.
"""

from __future__ import annotations

import os
import sys

if os.environ.get("_GIDDY_DIST_CHILD") != "1":
    # Re-exec with a clean CPU-mesh environment: JAX reads its platform and
    # device count once, at first use.
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
    ).strip()
    env["_GIDDY_DIST_CHILD"] = "1"
    os.execve(sys.executable, [sys.executable, os.path.abspath(__file__)], env)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import numpy as np

import giddy_tpu as gt
from giddy_tpu.dist import build_sharded_decoder, decode_sharded, default_mesh
from giddy_tpu.util import GROUP

from helpers import gen_column

DIST_SCHEMES = [
    "nbit", "for", "delta", "delta2", "dict", "rle", "rpe", "model", "bitmap", "dzbf", "dzbv", "raw", "patched", "xordelta", "alp",
]


def main() -> None:
    assert len(jax.devices()) == 8, jax.devices()
    rng = np.random.default_rng(77)
    for scheme in DIST_SCHEMES:
        v = gen_column(scheme, 16 * GROUP, rng)
        col = gt.encode(v, scheme)
        out = np.asarray(decode_sharded(col))
        np.testing.assert_array_equal(out, gt.decode_ref(col), err_msg=scheme)
        print(f"[dist] {scheme}: ok", flush=True)
    # ragged group counts (padded groups)
    for scheme in ("nbit", "delta", "rle", "bitmap", "dict", "patched", "dzbv", "alp"):
        v = gen_column(scheme, 3 * GROUP + 421, rng)
        col = gt.encode(v, scheme)
        np.testing.assert_array_equal(
            np.asarray(decode_sharded(col)), gt.decode_ref(col), err_msg=f"ragged-{scheme}"
        )
    print("[dist] ragged: ok", flush=True)
    # dzbv skew: a sorted column concentrates wide bytes in late groups,
    # so the shards' plane lengths differ widely — the per-shard plane
    # repack must equalize them and stay exact
    vs = np.sort(gen_column("dzbv", 12 * GROUP, rng).view(np.uint32)).view(np.int32)
    cols = gt.encode(vs, "dzbv")
    np.testing.assert_array_equal(
        np.asarray(decode_sharded(cols)), gt.decode_ref(cols), err_msg="dzbv-skew"
    )
    print("[dist] dzbv-skew: ok", flush=True)
    # output must stay sharded (no implicit gather)
    col = gt.encode(gen_column("nbit", 8 * GROUP, rng), "nbit")
    fn, args = build_sharded_decoder(col, default_mesh())
    u = fn(*args)
    assert len(u.sharding.device_set) == 8, u.sharding
    print("[dist] sharded-output: ok", flush=True)
    # patched (compressed indices) across shards
    v = gen_column("patched", 16 * GROUP, rng)
    col = gt.encode(v, "patched", kind="compressed")
    np.testing.assert_array_equal(np.asarray(decode_sharded(col)), gt.decode_ref(col))
    print("[dist] patched-compressed: ok", flush=True)
    # simulated shard failure -> idempotent re-decode of its group range
    # (SURVEY.md §6 failure-detection row: recovery = rerun the block)
    v = gen_column("delta", 16 * GROUP, rng)
    col = gt.encode(v, "delta")
    full = np.asarray(decode_sharded(col)).copy()
    failed_shard = 3
    ng_l = 2  # 16 groups over 8 devices
    lo, hi = failed_shard * ng_l, (failed_shard + 1) * ng_l
    full[lo * GROUP : hi * GROUP] = -1  # pretend the shard's output was lost
    from giddy_tpu.partial import decode_groups

    full[lo * GROUP : hi * GROUP] = decode_groups(col, lo, hi)
    np.testing.assert_array_equal(full, gt.decode_ref(col))
    print("[dist] shard-failure-recovery: ok", flush=True)
    # wide (64-bit) columns: both planes sharded, host recombine
    v64 = gen_column("wide", 16 * GROUP, rng)
    wcol = gt.encode(v64, "wide", base_scheme="delta")
    np.testing.assert_array_equal(decode_sharded(wcol), v64)
    print("[dist] wide-64bit: ok", flush=True)
    # 2D (hosts x chips) mesh: groups shard over both axes
    from giddy_tpu.dist import host_chip_mesh

    mesh2, axes = host_chip_mesh(4, 2)
    v = gen_column("delta", 16 * GROUP, rng)
    col = gt.encode(v, "delta")
    out = np.asarray(decode_sharded(col, mesh2, axes))
    np.testing.assert_array_equal(out, gt.decode_ref(col))
    print("[dist] host-chip-2d-mesh: ok", flush=True)
    # cascade: inner streams shard, dictionary replicates (broadcast once)
    for inner in ("rle", "delta", "nbit"):
        v = gen_column("cascade", 16 * GROUP, rng)
        col = gt.encode(v, "cascade", codes_scheme=inner)
        out = np.asarray(decode_sharded(col))
        np.testing.assert_array_equal(out, gt.decode_ref(col), err_msg=f"cascade-{inner}")
    print("[dist] cascade: ok", flush=True)
    # distributed scans: predicate counts + exact aggregates on the mesh,
    # incl. ragged tails AND whole pad groups (17 groups over 8 shards)
    from giddy_tpu.dist_query import (
        count_where_sharded, filter_bitmap_sharded, max_sharded, min_sharded, sum_sharded,
    )

    for scheme in ("nbit", "delta", "rle", "dict", "dzbv", "patched", "cascade"):
        v = gen_column(scheme, 16 * GROUP + 421, rng)
        col = gt.encode(v, scheme)
        med = int(np.median(v))
        assert count_where_sharded(col, "lt", med) == int((v < med).sum()), scheme
        assert sum_sharded(col) == int(v.astype(np.int64).sum()), scheme
        assert min_sharded(col) == int(v.min()), scheme
        assert max_sharded(col) == int(v.max()), scheme
    print("[dist] scans-int: ok", flush=True)
    # bitmap output stays sharded; pad bits pre-masked (count needs no fixup)
    col = gt.encode(gen_column("nbit", 16 * GROUP + 421, rng), "nbit")
    words = filter_bitmap_sharded(col, "ge", 0)
    assert len(words.sharding.device_set) == 8, words.sharding
    # wide (64-bit) sharded scans: plane-pieced compares and exact sums
    v64 = gen_column("wide", 16 * GROUP + 3, rng)
    wcol = gt.encode(v64, "wide")
    m64 = int(np.median(v64))
    assert count_where_sharded(wcol, "lt", m64) == int((v64 < m64).sum())
    assert sum_sharded(wcol) == int(np.sum(v64, dtype=object))
    assert min_sharded(wcol) == int(v64.min()) and max_sharded(wcol) == int(v64.max())
    # float32: total-order min/max, float64 host sum
    fv = rng.normal(0, 100, 16 * GROUP + 99).astype(np.float32)
    fcol = gt.encode(fv, "raw")
    assert count_where_sharded(fcol, "lt", 0.0) == int((fv < 0.0).sum())
    assert min_sharded(fcol) == fv.min() and max_sharded(fcol) == fv.max()
    assert abs(sum_sharded(fcol) - np.sum(fv, dtype=np.float64)) < 1e-6
    # scans on a 2D (hosts x chips) mesh
    mesh2d, axes2d = host_chip_mesh(4, 2)
    v = gen_column("for", 16 * GROUP + 421, rng)
    col = gt.encode(v, "for")
    med = int(np.median(v))
    assert count_where_sharded(col, "lt", med, mesh2d, axes2d) == int((v < med).sum())
    assert sum_sharded(col, mesh2d, axes2d) == int(v.astype(np.int64).sum())
    print("[dist] scans-wide-float: ok", flush=True)
    # distributed GROUP BY: per-key partials over the mesh, exact vs numpy
    from giddy_tpu.dist_query import group_reduce_sharded

    vocab = np.arange(12, dtype=np.int32) * 5 - 20
    kv = vocab[rng.integers(0, 12, 16 * GROUP + 421)]
    keys = gt.encode(kv, "cascade")
    mv = rng.integers(-(2**20), 2**20, kv.size).astype(np.int32)
    vals = gt.encode(mv, "for")
    r = group_reduce_sharded(keys, vals, ("count", "sum", "min", "max"))
    codes = np.searchsorted(vocab, kv)
    for c in range(12):
        sel = mv[codes == c]
        assert r.count[c] == sel.size
        assert r.sum[c] == int(sel.astype(np.int64).sum())
        assert r.min[c] == sel.min() and r.max[c] == sel.max()
    # filtered by a sharded bitmap from another column
    bm = filter_bitmap_sharded(vals, "ge", 0)
    r2 = group_reduce_sharded(keys, vals, ("count", "sum"), bitmap=bm)
    m = mv >= 0
    for c in range(12):
        sel = mv[m & (codes == c)]
        assert r2.count[c] == sel.size and r2.sum[c] == int(sel.astype(np.int64).sum())
    # wide (64-bit) measures: per-plane sharded sums, host min/max
    m64 = rng.integers(-(2**40), 2**40, kv.size, dtype=np.int64)
    w64 = gt.encode(m64, "wide")
    r3 = group_reduce_sharded(keys, w64, ("sum", "min", "max"))
    for c in range(12):
        sel = m64[codes == c]
        assert r3.sum[c] == int(sel.astype(object).sum())
        assert r3.min[c] == sel.min() and r3.max[c] == sel.max()
    # float64 measures must sum as floats, not bitpatterns (regression)
    f64 = rng.normal(0, 25, kv.size)
    rf = group_reduce_sharded(keys, gt.encode(f64, "wide"), ("sum",))
    for c in range(12):
        assert abs(rf.sum[c] - np.sum(f64[codes == c], dtype=np.float64)) < 1e-9
    print("[dist] groupby: ok", flush=True)
    # the filter fold itself must be collective-free (the bitmap stays
    # sharded; only a scalar count ever all-reduces)
    from giddy_tpu.dist_query import _args, _scan_fn
    from giddy_tpu.query import _stage_value
    import jax.numpy as jnp

    col = gt.encode(gen_column("delta", 16 * GROUP, rng), "delta")
    fn = _scan_fn(col, default_mesh(), "d", "filter", "lt")
    hlo = fn.lower(
        jnp.asarray(_stage_value(col.dtype, 0)), None, *_args(col, default_mesh(), "d")
    ).compile().as_text().lower()
    for coll in ("all-gather", "all-reduce", "collective-permute", "all-to-all", "reduce-scatter"):
        assert coll not in hlo, coll
    # nullable twin: the validity AND must also stay shard-local
    from giddy_tpu.dist_query import _valid_arg

    vn = gen_column("delta", 16 * GROUP, rng)
    vm = rng.random(vn.size) >= 0.1
    ncol = gt.encode(vn, "delta", valid=vm)
    fnn = _scan_fn(ncol, default_mesh(), "d", "filter", "lt")
    hlo = fnn.lower(
        jnp.asarray(_stage_value(ncol.dtype, 0)),
        _valid_arg(ncol, default_mesh(), "d"),
        *_args(ncol, default_mesh(), "d"),
    ).compile().as_text().lower()
    for coll in ("all-gather", "all-reduce", "collective-permute", "all-to-all", "reduce-scatter"):
        assert coll not in hlo, ("nullable", coll)
    print("[dist] zero-collective-scan: ok", flush=True)
    # nullable columns: sharded scans/aggregates skip null rows exactly
    from giddy_tpu.dist_query import group_reduce_sharded as grs

    med = int(np.median(vn[vm]))
    assert count_where_sharded(ncol, "lt", med) == int((vn[vm] < med).sum())
    assert sum_sharded(ncol) == int(vn[vm].astype(np.int64).sum())
    assert min_sharded(ncol) == int(vn[vm].min())
    kvn = vocab[rng.integers(0, 12, vn.size)]
    nkeys = gt.encode(kvn, "dict", valid=vm)
    rn = grs(nkeys, gt.encode(mv[: vn.size], "for"), ("count", "sum"))
    codes_n = np.searchsorted(vocab, kvn)
    for c in range(12):
        sel = mv[: vn.size][vm & (codes_n == c)]
        assert rn.count[c] == sel.size and rn.sum[c] == int(sel.astype(np.int64).sum())
    print("[dist] nullable: ok", flush=True)
    # string columns: sharded predicate scans lower to code-range scans
    from giddy_tpu.strings import count_where_str_sharded, encode_strings

    words = [b"ant", b"bee", b"cat", b"dog", b"elk"]
    sv = [words[i] for i in np.repeat(rng.integers(0, 5, 2 * GROUP), 40)[: 16 * GROUP]]
    scol = encode_strings(sv, codes_scheme="rle")
    sva = np.array(sv, object)
    assert count_where_str_sharded(scol, "ge", b"cat") == int((sva >= b"cat").sum())
    assert count_where_str_sharded(scol, "eq", b"bee") == int((sva == b"bee").sum())
    print("[dist] strings: ok", flush=True)
    # sharded membership scans (isin / semi-join): staged-set search per
    # shard, collective-free like every other fold
    from giddy_tpu.dist_query import (
        _isin_scan_fn, isin_bitmap_sharded, isin_count_sharded, semi_join_bitmap_sharded,
    )
    from giddy_tpu.query import _staged_set_u32, count_bits

    vi = gen_column("nbit", 16 * GROUP + 421, rng)
    icol = gt.encode(vi, "nbit")
    want_set = [int(x) for x in np.unique(vi)[::7]]
    assert isin_count_sharded(icol, want_set) == int(np.isin(vi, want_set).sum())
    # wide keys (lexicographic plane search)
    v64s = gen_column("wide", 16 * GROUP + 3, rng)
    wcols = gt.encode(v64s, "wide")
    w_set = [int(x) for x in np.unique(v64s)[:40]]
    assert isin_count_sharded(wcols, w_set) == int(np.isin(v64s, w_set).sum())
    # float32 (bitpattern space)
    f_set = [float(x) for x in fv[:25]]
    assert isin_count_sharded(fcol, f_set) == int(np.isin(fv, f_set).sum())
    # nullable probe: null rows never members
    n_set = [int(x) for x in np.unique(vn)[:30]]
    assert isin_count_sharded(ncol, n_set) == int((vm & np.isin(vn, n_set)).sum())
    # semi-join twin vs the single-chip Table path; strdict probe rewrite
    bcol = gt.encode(np.unique(vi)[::5].astype(np.int32), "raw")
    bm = np.asarray(semi_join_bitmap_sharded(icol, bcol))
    assert count_bits(bm, icol.n) == int(np.isin(vi, np.unique(vi)[::5]).sum())
    sbuild = encode_strings([b"bee", b"dog", b"owl"], codes_scheme="raw")
    bms = np.asarray(semi_join_bitmap_sharded(scol, sbuild))
    assert count_bits(bms, scol.n) == int(np.isin(sva, [b"bee", b"dog"]).sum())
    # str-kind (utf-8) probe and build — regression: bytes(v) crashed here
    sv_u = ["änt", "bee", "cät"]
    scol_u = encode_strings(
        [sv_u[i] for i in np.repeat(rng.integers(0, 3, 2 * GROUP), 8)[: 16 * GROUP]],
        codes_scheme="rle")
    sbuild_u = encode_strings(["cät", "owl"], codes_scheme="raw")
    got = count_bits(np.asarray(semi_join_bitmap_sharded(scol_u, sbuild_u)), scol_u.n)
    from giddy_tpu.strings import dictionary as _dic, codes_column as _cc

    want_code = [i for i, s in enumerate(_dic(scol_u)) if s == "cät"]
    cc = gt.decode_ref(_cc(scol_u))
    assert got == int(np.isin(cc, want_code).sum())
    # the membership fold is collective-free
    staged = _staged_set_u32(icol.dtype, want_set)
    fni = _isin_scan_fn(icol, default_mesh(), "d", staged.size)
    hlo = fni.lower(
        jnp.asarray(staged), None, *_args(icol, default_mesh(), "d")
    ).compile().as_text().lower()
    for coll in ("all-gather", "all-reduce", "collective-permute", "all-to-all", "reduce-scatter"):
        assert coll not in hlo, ("isin", coll)
    print("[dist] isin-semi-join: ok", flush=True)
    # sharded join prune: identical pairs to the single-chip path
    from giddy_tpu.join import join_indices

    perm = rng.permutation(12 * GROUP).astype(np.int32)  # distinct keys
    jl = gt.encode(perm[: 8 * GROUP], "nbit")
    jr = gt.encode(perm[4 * GROUP : 8 * GROUP], "nbit")
    li0, ri0 = join_indices(jl, jr)
    li1, ri1 = join_indices(jl, jr, mesh=default_mesh())
    np.testing.assert_array_equal(li0, li1)
    np.testing.assert_array_equal(ri0, ri1)
    assert li0.size > 0
    print("[dist] sharded-join: ok", flush=True)
    # dataset scans over the mesh: per-partition sharded folds
    import tempfile

    from giddy_tpu.dataset import Dataset
    from giddy_tpu.table import Table

    with tempfile.TemporaryDirectory() as td:
        pvs = []
        svs = []
        tabs = []
        for lo in (0, 50_000):
            pv = (np.sort(rng.integers(lo, lo + 40_000, 8 * GROUP))).astype(np.int32)
            sv2 = [["lo", "hi"][int(x >= 20_000)] for x in pv]
            pvs.append(pv)
            svs += sv2
            tabs.append(Table([gt.encode(pv, "delta", name="ts"),
                               encode_strings(sv2, name="lv")]))
        dset = Dataset.write(td, tabs)
        allv = np.concatenate(pvs)
        # thr INSIDE partition 0's range: its verdict is 'scan', so the
        # sharded AND-fold (_count_sharded) actually executes
        thr = 20_000
        assert [v for _, v in dset._plan([("ts", "lt", thr)])] == ["scan", "skip"]
        assert dset.count(("ts", "lt", thr), mesh=default_mesh()) == int((allv < thr).sum())
        # strdict predicate rides filter_bitmap_str_sharded in the same fold
        sva2 = np.array(svs, object)
        got = dset.count(("ts", "lt", 60_000), ("lv", "eq", "lo"), mesh=default_mesh())
        assert got == int(((allv < 60_000) & (sva2 == "lo")).sum())
        assert dset.agg("ts", "sum", mesh=default_mesh()) == int(allv.astype(np.int64).sum())
    print("[dist] dataset-mesh: ok", flush=True)
    # steady-state decode must move ZERO bytes between shards: the compiled
    # program may contain no collectives (SURVEY.md §3.11 comm-backend row —
    # this is the structural basis of the >=90% scaling target).
    for scheme in ("nbit", "delta", "rle", "dict"):
        v = gen_column(scheme, 16 * GROUP, rng)
        col = gt.encode(v, scheme)
        fn, args = build_sharded_decoder(col, default_mesh())
        hlo = fn.lower(*args).compile().as_text().lower()
        for coll in ("all-gather", "all-reduce", "collective-permute", "all-to-all", "reduce-scatter"):
            assert coll not in hlo, (scheme, coll)
    print("[dist] zero-collective-decode: ok", flush=True)
    print("ALL DIST CHECKS PASSED", flush=True)


if __name__ == "__main__":
    main()
