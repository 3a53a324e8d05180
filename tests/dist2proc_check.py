"""TWO-PROCESS jax.distributed decode drill (VERDICT r3 next #6).

The single-process 8-device virtual mesh (dist_checks.py) exercises the
shard_map program but never the multi-controller runtime: a
process-spanning mesh, per-process addressable shards, and the
cross-process replicated-stream broadcast — the pieces a multi-host
deployment (SURVEY.md CS-5) depends on.
This script is the closest local approximation: it spawns TWO OS processes
of 4 virtual CPU devices each, wires them with jax.distributed.initialize,
builds the 2D (host x chip) mesh, and runs the standard sharded decoders —
each process verifying its addressable shards bit-exactly against the CPU
oracle.

Run directly (`python tests/dist2proc_check.py`) — it re-launches itself
as coordinator + worker with clean CPU envs; exit 0 and the final
"ALL 2-PROCESS DIST CHECKS PASSED" line mean success.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

HERE = os.path.abspath(__file__)
SCHEMES = ["nbit", "delta", "dict", "rle", "model", "patched", "alp"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launcher() -> int:
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4"
        ).strip()
        env["_GIDDY_DIST2_CHILD"] = str(pid)
        env["_GIDDY_DIST2_PORT"] = str(port)
        procs.append(
            subprocess.Popen(
                [sys.executable, HERE],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    ok = True
    for pid, p in enumerate(procs):
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            ok = False
        outs.append(out)
        if p.returncode != 0:
            ok = False
    sys.stdout.write(outs[0])
    if not ok or "ALL 2-PROCESS DIST CHECKS PASSED" not in outs[0]:
        sys.stderr.write("---- process 1 output ----\n" + outs[1])
        return 1
    return 0


def worker() -> None:
    pid = int(os.environ["_GIDDY_DIST2_CHILD"])
    port = os.environ["_GIDDY_DIST2_PORT"]
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    sys.path.insert(0, os.path.dirname(HERE))

    import jax

    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()
    assert jax.local_device_count() == 4, jax.local_devices()
    assert len(jax.devices()) == 8, jax.devices()

    import numpy as np

    import giddy_tpu as gt
    from giddy_tpu.dist import build_sharded_decoder, host_chip_mesh
    from giddy_tpu.util import GROUP, num_groups

    from helpers import gen_column

    # 2D (host x chip) mesh with the process boundary on the host axis —
    # the CS-5 shape where replicated side streams broadcast across the
    # process (DCN-analog) boundary once per column
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    mesh, axis = host_chip_mesh(2, 4, devices)

    rng = np.random.default_rng(4242)  # identical columns on both processes
    for scheme in SCHEMES:
        v = gen_column(scheme, 16 * GROUP + 421, rng)
        col = gt.encode(v, scheme, name=f"d2_{scheme}")
        fn, args = build_sharded_decoder(col, mesh, axis)
        out = fn(*args)
        jax.block_until_ready(out)
        ref = gt.decode_ref(col).view(np.uint32)
        ref_pad = np.zeros(num_groups(col.n) * GROUP, np.uint32)
        ref_pad[: col.n] = ref
        n_local = 0
        for shard in out.addressable_shards:
            got = np.asarray(shard.data).reshape(-1)
            want_full = ref_pad[shard.index[0]]
            # only positions < n carry contract values (pad groups decode
            # to don't-care); compare the real prefix of this shard
            lo = shard.index[0].start or 0
            real = max(0, min(col.n - lo, got.shape[0]))
            np.testing.assert_array_equal(got[:real], want_full[:real], err_msg=scheme)
            n_local += got.shape[0]
        assert n_local > 0, "process owns no shards"
        if pid == 0:
            print(f"[dist2] {scheme}: ok ({n_local} elems/process)", flush=True)

    # --- round 5 (VERDICT r4 next #7): the full configs[4] surface on the
    # multi-controller mesh — the compiled programs can differ from the
    # single-process ones, so each gets its own 2-process proof ---

    # 1) mixed container, ONE jitted program for all columns (the
    #    decode_columns_sharded structure, verified per-process via
    #    addressable shards — a global np.asarray would need cross-process
    #    gathers)
    import jax as _jax

    mix = [
        (s, gen_column(s, 8 * GROUP + 99, rng))
        for s in ("delta", "dict", "rle", "patched")
    ]
    cols = [gt.encode(v, s, name=f"mix_{s}") for s, v in mix]
    built = [build_sharded_decoder(c, mesh, axis) for c in cols]
    fns = tuple(f for f, _ in built)

    @_jax.jit
    def run_container(args_list):
        return [f(*a) for f, a in zip(fns, args_list)]

    outs = run_container([a for _, a in built])
    _jax.block_until_ready(outs)
    for c, u in zip(cols, outs):
        ref = gt.decode_ref(c).view(np.uint32)
        ref_pad = np.zeros(num_groups(c.n) * GROUP, np.uint32)
        ref_pad[: c.n] = ref
        for shard in u.addressable_shards:
            got = np.asarray(shard.data).reshape(-1)
            lo = shard.index[0].start or 0
            real = max(0, min(c.n - lo, got.shape[0]))
            np.testing.assert_array_equal(
                got[:real], ref_pad[lo : lo + real], err_msg=f"mixed {c.name}"
            )
    if pid == 0:
        print("[dist2] mixed-container: ok (one program, 4 columns)", flush=True)

    # 2) sharded scans + GROUP BY across the process boundary
    from giddy_tpu.dist_query import count_where_sharded, group_reduce_sharded

    sv = gen_column("delta", 8 * GROUP + 77, rng)
    scol = gt.encode(sv, "delta", name="d2_scan")
    med = int(np.median(sv))
    assert count_where_sharded(scol, "lt", med, mesh, axis) == int((sv < med).sum())
    vocab = np.arange(9, dtype=np.int32) * 3 - 10
    kv = vocab[rng.integers(0, 9, 8 * GROUP + 77)]
    mv = rng.integers(-(2**20), 2**20, kv.size).astype(np.int32)
    r = group_reduce_sharded(
        gt.encode(kv, "cascade"), gt.encode(mv, "for"),
        ("count", "sum", "min", "max"), mesh=mesh, axis=axis,
    )
    codes = np.searchsorted(vocab, kv)
    for c in range(9):
        sel = mv[codes == c]
        assert int(r.count[c]) == sel.size
        assert int(r.sum[c]) == int(sel.astype(np.int64).sum())
        assert int(r.min[c]) == int(sel.min()) and int(r.max[c]) == int(sel.max())
    if pid == 0:
        print("[dist2] scans+groupby: ok", flush=True)

    # 3) zero-collective HLO machine-check ON THIS multi-controller mesh:
    #    the sharded filter fold compiled here must contain no collectives
    #    (the single-process check cannot stand in for this program)
    import jax.numpy as jnp

    from giddy_tpu.dist_query import _args, _scan_fn
    from giddy_tpu.query import _stage_value

    fn = _scan_fn(scol, mesh, axis, "filter", "lt")
    hlo = fn.lower(
        jnp.asarray(_stage_value(scol.dtype, 0)), None, *_args(scol, mesh, axis)
    ).compile().as_text().lower()
    for coll in ("all-gather", "all-reduce", "collective-permute",
                 "all-to-all", "reduce-scatter"):
        assert coll not in hlo, ("2proc-hlo", coll)
    if pid == 0:
        print("[dist2] zero-collective-hlo (multi-controller): ok", flush=True)

    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices("giddy_dist2_done")
    if pid == 0:
        print("ALL 2-PROCESS DIST CHECKS PASSED", flush=True)


if __name__ == "__main__":
    if "_GIDDY_DIST2_CHILD" in os.environ:
        worker()
        sys.exit(0)
    sys.exit(launcher())
