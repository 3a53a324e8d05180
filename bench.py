#!/usr/bin/env python
"""Decode throughput benchmark — BASELINE.json configs on the local GPU.

Prints ONE JSON line: the geometric-mean decode GB/s across the five
headline schemes (RLE/FOR/delta/dict/NBit — BASELINE.json "metric"), with
the device it ran on. Per-scheme detail goes to stderr and
results/bench_detail.json. Each measurement runs in a fresh child process,
so the parent never opens the GPU (one JAX process per card);
``--no-subproc`` measures in the parent instead, selftest included.

Usage:
  python bench.py [--n LOG2] [--schemes a,b,c|all] [--iters K] [--mixed]
                  [--dist] [--no-subproc]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax

import giddy_tpu as gt
from giddy_tpu.datagen import gen_column

HEADLINE = ["nbit", "for", "delta", "dict", "rle"]
from giddy_tpu.datagen import CORE_SCHEMES as ALL  # single source of truth


def _median_time(run, iters: int, batch: int = 4) -> float:
    """Median of per-batch timings after warmup, each batch ended by
    block_until_ready."""
    for _ in range(3):
        jax.block_until_ready(run())
    times = []
    for _ in range(max(iters, 5)):
        t0 = time.perf_counter()
        for _ in range(batch):
            out = run()
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / batch)
    times.sort()
    return times[len(times) // 2]


def prepare_scheme(scheme: str, n: int, rng):
    """Encode + compile + warm up (NOT timed)."""
    if scheme == "rle_dense":
        # runs of ~1: the deepest per-group run-table search
        v = gen_column("rle", n, rng, hard=True)
        col = gt.encode(v, "rle", name="bench_rle_dense")
        fn = gt.get_decoder(col)
        streams = gt.api.device_streams(col)
        jax.block_until_ready(streams)
        jax.block_until_ready(fn(streams))
        return col, (lambda: fn(streams))
    if scheme == "xordelta_narrow":
        # few active bit planes
        v = (np.cumsum(rng.integers(0, 3, n)) % 7).astype(np.int32).view(np.float32)
        col = gt.encode(v, "xordelta", name="bench_xor_narrow")
    else:
        v = gen_column(scheme, n, rng)
        col = gt.encode(v, scheme, name=f"bench_{scheme}")
    fn = gt.get_decoder(col)
    streams = gt.api.device_streams(col)
    jax.block_until_ready(streams)
    jax.block_until_ready(fn(streams))
    return col, (lambda: fn(streams))


def time_prepared(col, run, scheme: str, iters: int) -> dict:
    from giddy_tpu.roofline import column_roofline

    t = _median_time(run, iters)
    touched = (col.nbytes_compressed + col.nbytes_decoded) / 1e9
    rf = column_roofline(col)
    return {
        "device_kind": jax.devices()[0].device_kind,
        "decode_GBps": col.nbytes_decoded / 1e9 / t,
        "ratio": col.ratio,
        "hbm_touched_GBps": touched / t,
        "time_s": t,
        # SoL fraction vs the card's published HBM BW (roofline.HBM_BW)
        "sol_fraction": rf.sol_fraction(t),
        "sol_decode_GBps": rf.sol_decode_gbps,
    }


def bench_mixed(n: int, iters: int, rng) -> dict:
    """Mixed TPC-H-style column set (BASELINE configs[4]), one jitted
    program for the whole container."""
    cols = [
        gt.encode(gen_column(s, n // 4, rng), s, name=f"mix_{s}")
        for s in ("delta", "dict", "rle", "patched")
    ]
    decoders = [gt.get_decoder(c) for c in cols]
    streams = [gt.api.device_streams(c) for c in cols]
    jax.block_until_ready(streams)

    @jax.jit
    def run(ss):
        return [d(s) for d, s in zip(decoders, ss)]

    t = _median_time(lambda: run(streams), iters)
    decoded = sum(c.nbytes_decoded for c in cols) / 1e9
    comp = sum(c.nbytes_compressed for c in cols) / 1e9
    return {
        "decode_GBps": decoded / t,
        "ratio": decoded / comp,
        "hbm_touched_GBps": (decoded + comp) / t,
        "time_s": t,
    }


def bench_narrow(n: int, iters: int, rng) -> dict:
    """Storage-width decode: int8/int16 columns store narrow — decoded GB/s is measured against the *logical* byte count
    (n * itemsize), so the 4x/2x write-traffic saving shows up as a
    correspondingly lower HBM-touched figure, not inflated GB/s."""
    from giddy_tpu import api

    cols = [
        gt.encode(gen_column("nbit", n, rng).astype(np.uint8), "nbit", name="narrow_u8"),
        gt.encode((np.arange(n) % 20000).astype(np.int16), "delta", name="narrow_i16"),
    ]
    decoders = [gt.get_decoder(c, api.narrow_store_dtype(c)) for c in cols]
    streams = [api.device_streams(c) for c in cols]
    jax.block_until_ready(streams)

    @jax.jit
    def run(ss):
        return [d(s) for d, s in zip(decoders, ss)]

    t = _median_time(lambda: run(streams), iters)
    decoded = sum(c.nbytes_decoded for c in cols) / 1e9
    comp = sum(c.nbytes_compressed for c in cols) / 1e9
    return {
        "device_kind": jax.devices()[0].device_kind,
        "decode_GBps": decoded / t,
        "ratio": decoded / comp,
        "hbm_touched_GBps": (decoded + comp) / t,
        "time_s": t,
        "stores": ["uint8", "uint16"],
    }


def bench_dist(n: int, iters: int, rng) -> dict:
    """Sharded decode of a mixed scheme set over ALL local devices.

    ``n`` is per-shard work (weak scaling): decode is collective-free data
    parallelism, so the honest efficiency statement is GB/s per shard at
    constant shard size — strong scaling at small n measures dispatch
    overhead, not the decode. Efficiency vs 1 shard still uses the linear
    formula GBps_nd / (nd * GBps_1)."""
    from giddy_tpu.dist import build_sharded_decoder, default_mesh

    mesh = default_mesh()
    n_total = n * len(mesh.devices.flat)
    cols = [
        gt.encode(gen_column(s, n_total // 4, rng), s, name=f"dist_{s}")
        for s in ("nbit", "delta", "dict", "rle")
    ]
    built = [build_sharded_decoder(c, mesh) for c in cols]

    def run():
        return [f(*a) for f, a in built]

    jax.block_until_ready(run())
    t = _median_time(run, iters)
    decoded = sum(c.nbytes_decoded for c in cols) / 1e9
    return {
        "devices": len(mesh.devices.flat),
        "backend": jax.default_backend(),
        "decode_GBps": decoded / t,
        "time_s": t,
    }


def _run_one(kind: str, n: int, iters: int) -> dict:
    """Executed in a fresh child process (--one): the parent stays off the
    GPU; the persistent compile cache keeps each child's compile cost low."""
    rng = np.random.default_rng(0)
    if kind == "mixed":
        return bench_mixed(n, iters, rng)
    if kind == "dist":
        return bench_dist(n, iters, rng)
    if kind == "narrow":
        return bench_narrow(n, iters, rng)
    col, run = prepare_scheme(kind, n, rng)
    return time_prepared(col, run, kind, iters)


def _spawn_one(kind: str, args) -> dict:
    """Median-GB/s trial of ``--trials`` fresh child processes."""
    import subprocess
    import tempfile

    out = []
    for _ in range(max(1, args.trials)):
        with tempfile.NamedTemporaryFile(suffix=".json") as tf:
            cmd = [sys.executable, os.path.abspath(__file__), "--one", kind,
                   "--n", str(args.n), "--iters", str(args.iters), "--out", tf.name]
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise RuntimeError(f"bench subprocess {kind} failed:\n{proc.stderr[-2000:]}")
            out.append(json.loads(pathlib.Path(tf.name).read_text()))
    out.sort(key=lambda r: r["decode_GBps"])
    return out[len(out) // 2]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=26, help="log2 of element count per column")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--trials", type=int, default=3,
                    help="fresh-process trials per scheme; the median is kept")
    ap.add_argument("--schemes", type=str, default=",".join(HEADLINE))
    ap.add_argument("--mixed", action="store_true", help="also run the mixed-container config")
    ap.add_argument("--dist", action="store_true", help="also run sharded decode over local devices")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)  # internal
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)  # internal
    ap.add_argument("--no-subproc", action="store_true",
                    help="measure in this process (the parent then holds the GPU)")
    ap.add_argument("--no-selftest", action="store_true",
                    help="skip the device-vs-oracle selftest pass")
    ap.add_argument("--no-narrow", action="store_true",
                    help="skip the storage-width (int8/int16) decode measurement")
    args = ap.parse_args()
    from giddy_tpu.util import enable_compile_cache

    enable_compile_cache()
    n = 1 << args.n
    if args.one:
        r = _run_one(args.one, n, args.iters)
        pathlib.Path(args.out).write_text(json.dumps(r))
        return
    schemes = ALL if args.schemes == "all" else args.schemes.split(",")
    detail = {"n": n, "schemes": {}}
    rng = np.random.default_rng(0)
    for scheme in schemes:
        if args.no_subproc:
            col, run = prepare_scheme(scheme, n, rng)
            r = time_prepared(col, run, scheme, args.iters)
        else:
            r = _spawn_one(scheme, args)
        detail["schemes"][scheme] = r
        print(f"[bench] {scheme:8s} {r['decode_GBps']:9.2f} GB/s decoded  "
              f"(ratio {r['ratio']:6.2f}x, HBM {r['hbm_touched_GBps']:8.2f} GB/s, "
              f"{r['time_s'] * 1e3:.3f} ms)", file=sys.stderr)
    if args.mixed:
        r = bench_mixed(n, args.iters, rng) if args.no_subproc else _spawn_one("mixed", args)
        detail["mixed"] = r
        print(f"[bench] {'mixed':8s} {r['decode_GBps']:9.2f} GB/s decoded  "
              f"(ratio {r['ratio']:6.2f}x, {r['time_s'] * 1e3:.3f} ms)", file=sys.stderr)
    if not args.no_narrow:
        r = bench_narrow(n, args.iters, rng) if args.no_subproc else _spawn_one("narrow", args)
        detail["narrow"] = r
        print(f"[bench] {'narrow':8s} {r['decode_GBps']:9.2f} GB/s decoded  "
              f"(storage-width stores, ratio {r['ratio']:6.2f}x, "
              f"{r['time_s'] * 1e3:.3f} ms)", file=sys.stderr)
    if args.dist:
        r = bench_dist(n, args.iters, rng) if args.no_subproc else _spawn_one("dist", args)
        detail["dist"] = r
        print(f"[bench] {'dist':8s} {r['decode_GBps']:9.2f} GB/s decoded on "
              f"{r['devices']} device(s)", file=sys.stderr)
    head = [s for s in HEADLINE if s in detail["schemes"]] or list(detail["schemes"])
    gbps = [detail["schemes"][s]["decode_GBps"] for s in head]
    geo = math.exp(sum(math.log(g) for g in gbps) / len(gbps))
    outdir = pathlib.Path(__file__).parent / "results"
    outdir.mkdir(exist_ok=True)
    (outdir / "bench_detail.json").write_text(json.dumps(detail, indent=2))
    if not args.no_selftest:
        detail["selftest_pass"] = _run_selftest(outdir, in_process=args.no_subproc)
        (outdir / "bench_detail.json").write_text(json.dumps(detail, indent=2))
    line = {
        "metric": "decode_GBps_geomean_headline5",
        "value": round(geo, 2),
        "unit": "GB/s",
        "device_kind": detail["schemes"][head[0]]["device_kind"],
    }
    if "selftest_pass" in detail:
        line["selftest_pass"] = detail["selftest_pass"]
    print(json.dumps(line))


def _run_selftest(outdir: pathlib.Path, in_process: bool) -> bool:
    """Device-vs-oracle + traffic-audit selftest (giddy_tpu/selftest.py) —
    in a fresh child process, or in this one when it already holds the
    GPU. Never fails the bench; the verdict lands in the JSON."""
    out = outdir / "selftest.json"
    if in_process:
        from giddy_tpu.selftest import main as selftest_main

        ok = selftest_main(["--out", str(out)]) == 0
    else:
        import subprocess

        proc = subprocess.run(
            [sys.executable, "-m", "giddy_tpu.selftest", "--out", str(out)],
            capture_output=True, text=True, timeout=3600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        ok = proc.returncode == 0
        if not ok:
            print(proc.stderr[-2000:], file=sys.stderr)
    print(f"[bench] selftest {'PASS' if ok else 'FAIL'}", file=sys.stderr)
    return ok


if __name__ == "__main__":
    main()
