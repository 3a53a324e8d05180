#!/usr/bin/env python
"""Prove the decode path on an NVIDIA GPU, at real column sizes.

Default (one GPU) — phases in order; any failure ends the run non-zero:

1. Name the card (``nvidia-smi``, in a child process that never imports
   JAX) and refuse any JAX device that is not a GPU.
2. BASELINE configs[0]-[3] through ``gt.decode``, bit-exact against the
   input values: 2**28 int32 packed to 9 bits (1 GiB decoded); delta and
   for on 2**26 sorted timestamps; dict (d = 1000) on 2**26 values; rle
   and rpe on 2**26 status flags. Prints the configs[0] decoder's
   ``memory_analysis()`` first, then each warm decode time (information,
   not a metric).
3. Every scheme and composite: ``giddy_tpu.selftest.run_selftest`` at
   2**24 + 999 elements per column, which must pass. Its traffic-audit
   figures are printed, not gated on.
4. The query surface end to end: ``examples/tpch_demo.main(n=2**22)``,
   every answer checked against NumPy.

``--four`` runs only the sharded phase on a 1-D mesh of four GPUs: the
8-column mixed container (``datagen.mixed_container``) at 2**24 rows per
column through ``dist.decode_sharded`` and ``dist.decode_columns_sharded``,
each compared with one-device ``gt.decode`` and ``decode_ref``, with the
output shards checked to span all four devices; then
``count_where_sharded``, ``sum_sharded``, ``group_reduce_sharded`` and
``isin_count_sharded`` against their one-device twins and NumPy.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

# element counts per phase on the card; tests inject smaller ones
FULL = {
    "config0": 1 << 28,
    "config123": 1 << 26,
    "selftest": (1 << 24) + 999,
    "tpch": 1 << 22,
    "four": 1 << 24,
}


def card_name() -> str:
    """The cards' names and power limits, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def require_gpu(devices, count: int) -> None:
    """Refuse to run anywhere but on ``count`` GPUs: no CPU fallback."""
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU; JAX found {devices[0].platform!r}"
        )
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs; JAX found {len(devices)}")


def _log(msg: str) -> None:
    print(msg, flush=True)


def _warm_ms(fn, iters: int = 5) -> float:
    """Median wall time (ms) of ``iters`` calls after one warm-up call,
    each ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def _check_decode(col, want: np.ndarray, card: str, label: str) -> None:
    import giddy_tpu as gt
    from giddy_tpu.api import device_streams, narrow_store_dtype

    got = np.asarray(gt.decode(col))
    if got.dtype != want.dtype or not np.array_equal(got.view(np.uint8), want.view(np.uint8)):
        raise AssertionError(f"{label}: decode is not bit-exact")
    fn = gt.get_decoder(col, narrow_store_dtype(col))
    streams = device_streams(col)
    ms = _warm_ms(lambda: fn(streams))
    _log(f"[baseline] {label}: exact; warm decode {ms:.3f} ms on {card} "
         f"({col.nbytes_decoded / ms / 1e6:.1f} GB/s decoded)")


def _status_flags(n: int, rng) -> np.ndarray:
    v = np.zeros(n, dtype=np.int32)
    pos = 0
    while pos < n:
        ln = int(rng.integers(100, 5000))
        v[pos : pos + ln] = int(rng.integers(0, 5))
        pos += ln
    return v


def phase_baseline(sizes: dict, card: str) -> None:
    import giddy_tpu as gt
    from giddy_tpu.api import device_streams

    n0 = sizes["config0"]
    rng = np.random.default_rng(0)
    v = rng.integers(0, 512, n0, dtype=np.int64).astype(np.int32)
    col = gt.encode(v, "nbit", bits=9, name="config0")
    ma = gt.get_decoder(col).lower(device_streams(col)).compile().memory_analysis()
    _log(f"[baseline] config0 memory_analysis: argument {ma.argument_size_in_bytes} B, "
         f"output {ma.output_size_in_bytes} B, temp {ma.temp_size_in_bytes} B, "
         f"generated code {ma.generated_code_size_in_bytes} B")
    _check_decode(col, v, card, f"config0 nbit 9-bit n={n0}")
    del v, col

    n = sizes["config123"]
    rng = np.random.default_rng(1)
    ts = (np.cumsum(rng.integers(0, 4, n)) + 1_700_000_000).astype(np.int32)
    for scheme in ("delta", "for"):
        _check_decode(gt.encode(ts, scheme), ts, card, f"config1 {scheme} n={n}")
    rng = np.random.default_rng(2)
    vocab = rng.integers(-(2**31), 2**31 - 1, 1000, dtype=np.int64).astype(np.int32)
    dv = vocab[rng.integers(0, 1000, n)]
    col = gt.encode(dv, "dict")
    assert col.params["dict_size"] == 1000, col.params
    _check_decode(col, dv, card, f"config2 dict d=1000 n={n}")
    flags = _status_flags(n, np.random.default_rng(3))
    for scheme in ("rle", "rpe"):
        _check_decode(gt.encode(flags, scheme), flags, card, f"config3 {scheme} n={n}")
    import jax

    if jax.devices()[0].platform == "gpu":  # XLA:CPU flushes denormals
        _check_denormals()


def _check_denormals() -> None:
    """ALP's one float op (int32 -> f32 convert, one f32 multiply) must
    keep denormal results on the card, as the NumPy oracle does."""
    import jax
    import jax.numpy as jnp

    enc = np.arange(1, 4097, dtype=np.int32)
    scale = np.float32(1e-41)
    got = np.asarray(jax.jit(lambda q: q.astype(jnp.float32) * scale)(enc))
    want = enc.astype(np.float32) * scale
    if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError("f32 multiply flushed or rounded denormal results")
    _log("[baseline] f32 denormal multiply: exact")


def phase_selftest(sizes: dict) -> None:
    from giddy_tpu.selftest import TRAFFIC_CAP, run_selftest

    report = run_selftest(sizes["selftest"])
    for name, e in report["schemes"].items():
        if "traffic_vs_sol" in e:
            _log(f"[selftest] {name}: temp {e['temp_bytes']} B, traffic/ideal "
                 f"{e['traffic_vs_ideal']}, traffic/sol {e['traffic_vs_sol']}")
    _log(f"[selftest] traffic_ok={report.get('traffic_ok')} (cap {TRAFFIC_CAP}, not gated)")
    bad = [k for k, e in report["schemes"].items() if not e.get("exact")]
    if not report["pass"]:
        raise AssertionError(f"selftest failed: {bad} {report.get('uncovered_schemes', '')}")
    _log(f"[selftest] n={sizes['selftest']}: all {len(report['schemes'])} checks exact")


def phase_tpch(sizes: dict) -> None:
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import tpch_demo

    tpch_demo.main(n=sizes["tpch"])
    _log(f"[tpch] n={sizes['tpch']}: every answer matches NumPy")


def _on_all(arr, devices, label: str) -> None:
    held = {s.device for s in arr.addressable_shards}
    if held != set(devices):
        raise AssertionError(f"{label}: output shards on {sorted(d.id for d in held)}")


def phase_four(sizes: dict) -> None:
    import jax

    import giddy_tpu as gt
    from giddy_tpu import aggregate, groupby, query
    from giddy_tpu.datagen import mixed_container
    from giddy_tpu.dist import decode_columns_sharded, decode_sharded, default_mesh
    from giddy_tpu.dist_query import (
        count_where_sharded,
        group_reduce_sharded,
        isin_count_sharded,
        sum_sharded,
    )

    devices = jax.devices()[:4]
    mesh = default_mesh(devices=devices)
    n = sizes["four"]
    cols = mixed_container(n, np.random.default_rng(1))
    outs = decode_columns_sharded(cols, mesh)
    refs = {}
    for col in cols:
        ref = gt.decode_ref(col)
        refs[col.name] = ref
        one = np.asarray(gt.decode(col))
        sh = decode_sharded(col, mesh)
        _on_all(sh, devices, f"decode_sharded {col.name}")
        _on_all(outs[col.name], devices, f"decode_columns_sharded {col.name}")
        for label, got in (("one-device", one), ("sharded", np.asarray(sh)),
                           ("container", np.asarray(outs[col.name]))):
            if not np.array_equal(got.view(np.uint8), ref.view(np.uint8)):
                raise AssertionError(f"{col.scheme} {col.name}: {label} decode differs")
        _log(f"[four] {col.scheme} {col.name}: one-device == sharded == container == ref, "
             f"shards on {len(devices)} devices")
    nb, dc = cols[1], cols[2]
    v, k = refs[nb.name], refs[dc.name]
    want = int((v < 2048).sum())
    got = (count_where_sharded(nb, "lt", 2048, mesh), query.count_where(nb, "lt", 2048))
    assert got == (want, want), ("count_where", got, want)
    want = int(v.astype(np.int64).sum())
    got = (sum_sharded(nb, mesh), aggregate.sum_(nb))
    assert got == (want, want), ("sum", got, want)
    vals = [int(x) for x in v[:12]]
    want = int(np.isin(v, vals).sum())
    got = isin_count_sharded(nb, vals, mesh)
    assert got == want, ("isin_count", got, want)
    aggs = ("count", "sum", "min", "max")
    r4 = group_reduce_sharded(dc, nb, aggs=aggs, mesh=mesh)
    r1 = groupby.group_reduce(dc, nb, aggs=aggs)
    for i, key in enumerate(np.asarray(r4.keys)):
        m = k == key
        want = (int(m.sum()), int(v[m].astype(np.int64).sum()), int(v[m].min()), int(v[m].max()))
        for r, label in ((r4, "sharded"), (r1, "one-device")):
            got = (int(r.count[i]), int(r.sum[i]), int(r.min[i]), int(r.max[i]))
            assert got == want, ("group_reduce", label, int(key), got, want)
    _log("[four] count_where/sum/isin_count/group_reduce: sharded == one-device == NumPy")


def main(argv=None, *, device_check=require_gpu, card=card_name, sizes=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded phase, on a mesh of four GPUs")
    args = ap.parse_args(argv)
    sizes = dict(FULL, **(sizes or {}))
    count = 4 if args.four else 1
    import jax

    from giddy_tpu.util import enable_compile_cache

    device_check(jax.devices(), count)
    cards = card()
    _log(f"card: {cards}")
    cache = enable_compile_cache()
    _log(f"compile cache: {cache}")
    t0 = time.perf_counter()
    phases = [phase_four] if args.four else [
        lambda s: phase_baseline(s, cards.splitlines()[0]), phase_selftest, phase_tpch,
    ]
    for phase in phases:
        phase(sizes)
        _log(f"[time] {time.perf_counter() - t0:.1f} s")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
