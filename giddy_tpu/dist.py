"""Multi-device / multi-host decode — shard_map data parallelism.

New scope relative to the single-GPU reference (SURVEY.md §3.11, §6, call
stack CS-5): the GROUP tile is the unit of distribution (FORMAT.md §3) —
per-group streams shard on the group dimension, small side streams
(dictionaries, frame references, model coefficients, bitmap values)
replicate and are broadcast once per column, and steady-state decode needs
zero per-element communication. Each shard runs the *same* decoder a
single device runs, inside ``shard_map``.

Multi-host entry: ``jax.distributed.initialize()`` by the caller, then a
mesh over all devices; the network only ever carries the initial replicated-stream
broadcast.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from . import registry
from .format import EncodedColumn
from .util import GROUP, LANES, cdiv, num_groups


def default_mesh(axis: str = "d", devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def host_chip_mesh(n_hosts: int, chips_per_host: int, devices=None) -> tuple[Mesh, tuple]:
    """2D (hosts, chips) mesh + the axis tuple to shard groups over both
    (decode is pure DP, so the group dim shards over the flattened mesh;
    keeping the axes separate lets callers route replicated-stream
    broadcasts host-locally over ICI first). Pass axis=('h','c') to the
    sharded decoders."""
    devices = devices if devices is not None else jax.devices()
    grid = np.asarray(devices).reshape(n_hosts, chips_per_host)
    return Mesh(grid, ("h", "c")), ("h", "c")


@dataclasses.dataclass
class DistForm:
    """A column rewritten so every stream is either per-group (leading dim =
    ng, shardable on it) or replicated; plus the local column template whose
    decoder each shard runs."""

    local_col: EncodedColumn  # params/n describe ONE shard's slice
    sharded: dict[str, np.ndarray]  # leading dim = ng_padded
    replicated: dict[str, np.ndarray]
    bitmap_axis1: bool = False  # bitmaps shard on axis 1, not 0
    shard_leading: bool = False  # streams carry an explicit shard dim 0
    ng: int = 0  # unpadded group count
    # patched-only: applied globally after the shard_map
    patch_streams: dict[str, np.ndarray] | None = None
    patch_params: dict | None = None


def _pad_groups(a: np.ndarray, ng: int, ng_pad: int, axis: int = 0) -> np.ndarray:
    if ng == ng_pad:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, ng_pad - ng)
    return np.pad(a, pad)


def dist_form(col: EncodedColumn, n_shards: int) -> DistForm:
    """Rewrite `col` for an n_shards mesh (FORMAT.md §3 sharding contract)."""
    ng = num_groups(col.n)
    ng_pad = cdiv(ng, n_shards) * n_shards
    ng_l = ng_pad // n_shards
    scheme, p, st = col.scheme, col.params, col.streams

    def local(params: dict, streams: dict[str, np.ndarray], repl: dict[str, np.ndarray] | None = None, **kw):
        lc = EncodedColumn(
            name=col.name, scheme=kw.pop("scheme", scheme), dtype=col.dtype,
            n=ng_l * GROUP, params=params, streams={},
        )
        axis1 = kw.get("bitmap_axis1", False)
        return DistForm(
            local_col=lc,
            sharded={
                k: _pad_groups(v, ng, ng_pad, axis=1 if (axis1 and k == "bitmaps") else 0)
                for k, v in streams.items()
            },
            replicated=repl or {},
            ng=ng,
            **kw,
        )

    if scheme in ("nbit", "dzbf"):
        return local(dict(p), {"packed": st["packed"]})
    if scheme == "raw":
        return local({}, {"data": st["data"].reshape(ng, GROUP)})
    if scheme in ("delta", "xordelta"):
        return local(dict(p), {"packed": st["packed"], "anchors": st["anchors"].reshape(ng, 1)})
    if scheme == "delta2":
        return local(dict(p), {
            "packed": st["packed"],
            "anchors": st["anchors"].reshape(ng, 1),
            "slopes": st["slopes"].reshape(ng, 1),
        })
    if scheme == "for":
        gpf = p["frame_len"] // GROUP
        refs_g = np.repeat(st["refs"], gpf)[:ng].reshape(ng, 1)
        return local({"bits": p["bits"], "frame_len": GROUP}, {"packed": st["packed"], "refs_g": refs_g})
    if scheme == "model":
        from .kernels import model as k_model

        pre = k_model.prep(col)  # host-expanded (ng,1) per-group coefficients
        return local(
            {"bits": p["bits"], "frame_len": GROUP, "kind": p["kind"]},
            {k: pre[k] for k in ("packed", "a_g", "b_g", *(["c_g"] if "c_g" in pre else []))},
        )
    if scheme == "dict":
        return local(dict(p), {"codes": st["codes"]}, repl={"values": st["values"]})
    if scheme == "cascade":
        # Recurse on the nested code column; re-prefix its dist form and
        # replicate the dictionary (same broadcast-once rule as dict).
        from .ref.cascade import codes_column

        df = dist_form(codes_column(col), n_shards)
        lc = df.local_col
        df.local_col = EncodedColumn(
            name=col.name, scheme="cascade", dtype=col.dtype, n=lc.n,
            params={"codes_scheme": lc.scheme, "codes_params": lc.params,
                    "dict_size": p["dict_size"]},
            streams={},
        )
        df.sharded = {f"c_{k}": v for k, v in df.sharded.items()}
        df.replicated = {f"c_{k}": v for k, v in df.replicated.items()}
        df.replicated["values"] = st["values"]
        return df
    if scheme in ("rle", "rpe"):
        from .kernels.rle import run_tables

        r_pad = p["r_pad"]
        key = "run_ends" if scheme == "rle" else "run_starts"
        bounds = st[key].reshape(ng, r_pad)
        vals = st["run_values"].reshape(ng, r_pad)
        if ng != ng_pad:  # pad groups: one run ending at GROUP
            bounds = np.concatenate([bounds, np.full((ng_pad - ng, r_pad), GROUP, np.int32)])
            vals = _pad_groups(vals, ng, ng_pad)
        df = local(dict(p), {}, repl={})
        df.sharded = run_tables(vals, bounds, positions=(scheme == "rpe"))
        return df
    if scheme == "bitmap":
        d = p["d"]
        bitmaps = st["bitmaps"].reshape(d, ng, LANES)
        return local(dict(p), {"bitmaps": bitmaps}, repl={"values": st["values"]}, bitmap_axis1=True)
    if scheme == "dzbv":
        # Plane data is not group-aligned with the column (plane k holds
        # bytes only for elements with width > k), so each shard's plane
        # slice is re-packed into its own LMP groups host-side; per-shard
        # plane lengths are equalized by zero-padding (decode's rank gather
        # never reads past the shard's real count, so padding is inert).
        from .ref.lmp import lmp_pack, lmp_unpack

        # unpack only the ng real groups, then pad (reading ng_pad groups
        # from an ng-group buffer would run off the end)
        widths = np.zeros(ng_pad * GROUP, np.int32)
        widths[: ng * GROUP] = lmp_unpack(st["widths"], 2, ng * GROUP).astype(np.int32) + 1
        widths[col.n :] = 0  # pad elements select no planes beyond plane0
        w_sh = widths.reshape(n_shards, ng_l * GROUP)
        shard_streams: dict[str, np.ndarray] = {
            "widths": _pad_groups(st["widths"], ng, ng_pad).reshape(n_shards, ng_l, -1)
        }
        plane_lens_local = []
        for k in range(4):
            if k == 0:
                sel = [np.minimum(w, 1).astype(bool) for w in w_sh]
            else:
                sel = [w > k for w in w_sh]
            counts = [int(s.sum()) for s in sel]
            m_max = max(counts) if counts else 0
            plane_lens_local.append(m_max)
            if k > 0 and col.params["plane_lens"][k] == 0:
                plane_lens_local[k] = 0
                continue
            full = lmp_unpack(st[f"plane{k}"], 8, col.params["plane_lens"][k])
            # split the global plane by shard-element membership
            gmask = np.concatenate(sel)
            owner = np.repeat(np.arange(n_shards), ng_l * GROUP)[gmask]
            per_shard = []
            for s in range(n_shards):
                seg = full[: gmask.sum()][owner == s]
                pad = np.zeros(m_max - seg.shape[0], np.uint32)
                per_shard.append(lmp_pack(np.concatenate([seg, pad]), 8))
            shard_streams[f"plane{k}"] = np.stack(per_shard)
        lc = EncodedColumn(
            name=col.name, scheme="dzbv", dtype=col.dtype, n=ng_l * GROUP,
            params={"plane_lens": plane_lens_local}, streams={},
        )
        return DistForm(
            local_col=lc, sharded=shard_streams, replicated={}, ng=ng, shard_leading=True
        )
    if scheme == "alp":
        # FOR-shaped main streams shard on groups; exceptions ride the
        # patched mechanism (replicated, scattered shard-locally after)
        df = local(
            {"bits": p["bits"], "corr_bits": p["corr_bits"], "exp_e": p["exp_e"], "count": 0},
            {"packed": st["packed"], "corr": st["corr"], "refs_g": st["refs"].reshape(ng, 1)},
        )
        if p["count"]:
            df.patch_streams = {"patch_pos": st["patch_pos"], "patch_val": st["patch_val"]}
            df.patch_params = {"kind": "naive", "count": p["count"]}
        return df
    if scheme == "patched":
        base = EncodedColumn(
            name=col.name, scheme=col.params["base_scheme"], dtype=col.dtype, n=col.n,
            params=dict(p["base_params"]),
            streams={k[len("base_"):]: v for k, v in st.items() if k.startswith("base_")},
        )
        df = dist_form(base, n_shards)
        df.patch_streams = {k: v for k, v in st.items() if not k.startswith("base_")}
        df.patch_params = {
            "kind": p["kind"],
            "count": p["count"],
            **{k: v for k, v in p.items() if k.startswith("ppos_")},
        }
        return df
    raise NotImplementedError(f"dist decode for scheme {scheme!r}")


def _spec_for(arr: np.ndarray, axis, axis1: bool) -> P:
    shard_dim = 1 if axis1 else 0
    dims = [None] * arr.ndim
    dims[shard_dim] = axis  # str, or tuple of axes (2D host x chip mesh)
    return P(*dims)


def _mesh_key(mesh: Mesh, axis) -> tuple:
    return (
        tuple(mesh.axis_names),
        mesh.devices.shape,
        tuple(d.id for d in mesh.devices.flat),
        axis if isinstance(axis, str) else tuple(axis),
    )


def _df_signature(df: DistForm) -> tuple:
    """Everything the jitted decoder's *structure* depends on. dist_form can
    change stream shapes with stream CONTENTS for the same static_key
    (e.g. dzbv's per-shard plane lengths), so the fn cache verifies this
    signature instead of trusting static_key alone."""
    import json

    return (
        df.local_col.static_key(),
        tuple(sorted((k, v.shape, str(v.dtype)) for k, v in df.sharded.items())),
        tuple(sorted((k, v.shape, str(v.dtype)) for k, v in df.replicated.items())),
        df.bitmap_axis1,
        df.shard_leading,
        tuple(sorted(df.patch_streams)) if df.patch_streams else None,
        json.dumps(df.patch_params, sort_keys=True) if df.patch_params else None,
    )


# (col static_key, mesh key) -> (df signature, jitted fn). Hit = reuse the
# traced/compiled program; only dist_form + device_put run per call. Bounded
# FIFO: a long-lived service decoding many distinct column shapes must not
# accumulate compiled executables forever (pre-cache behavior let them be
# collected per call).
_DECODER_FN_CACHE: dict[tuple, tuple] = {}
_CACHE_CAP = 256


def _cache_put(cache: dict, key, value) -> None:
    if key not in cache and len(cache) >= _CACHE_CAP:
        cache.pop(next(iter(cache)))
    cache[key] = value


def _dist_form_cached(col: EncodedColumn, nd: int) -> DistForm:
    """Memoize the host restructure ON the column object (VERDICT r4 weak
    #6): the common case is repeated decode of one immutable column, and
    storing the form as an attribute makes its lifetime track the column's
    (no global cache pinning column-sized copies after the source dies).
    The signature carries nd + the identity of every stream array, so
    REPLACING a stream (col.streams['packed'] = new_arr) recomputes; only
    in-place writes into the same array object (arr[:] = ...) are
    undetectable — mutate columns by replacement, as the codebase does."""
    sig = (nd, tuple(sorted((k, id(v)) for k, v in col.streams.items())))
    hit = getattr(col, "_dist_form_cache", None)
    if hit is not None and hit[0] == sig:
        return hit[1]
    df = dist_form(col, nd)
    col._dist_form_cache = (sig, df)
    return df


def build_sharded_decoder(col: EncodedColumn, mesh: Mesh, axis: str = "d"):
    """Returns (jitted_fn, device_args) decoding the whole column on the
    mesh; output is the uint32 value array (n_pad_global,), group-sharded.

    The fn is cached per (column static key, mesh) and the host restructure
    (dist_form) per column identity; repeated calls with the same column
    re-run only the input placement (device_put — the data genuinely must
    move each call), and calls with fresh data re-run the restructure."""
    nd = int(np.prod([mesh.shape[a] for a in (axis if isinstance(axis, tuple) else (axis,))]))
    df = _dist_form_cached(col, nd)
    key = (col.static_key(), _mesh_key(mesh, axis))
    sig = _df_signature(df)
    cached = _DECODER_FN_CACHE.get(key)
    if cached is None or cached[0] != sig:
        cached = (sig, _build_fn(df, mesh, axis))
        _cache_put(_DECODER_FN_CACHE, key, cached)
    return cached[1], _device_args(df, mesh, axis)


def _build_fn(df: DistForm, mesh: Mesh, axis):
    builder = registry.get(df.local_col.scheme).decode_device
    local_decode = builder(df.local_col)
    names = sorted(df.sharded) + sorted(df.replicated)
    in_specs = tuple(
        _spec_for(df.sharded[k], axis, df.bitmap_axis1 and k == "bitmaps") for k in sorted(df.sharded)
    ) + tuple(P() for _ in sorted(df.replicated))

    n_sharded = len(df.sharded)

    def sharded_fn(*arrays):
        if df.shard_leading:  # local view is (1, ...): drop the shard dim
            arrays = tuple(a[0] for a in arrays[:n_sharded]) + arrays[n_sharded:]
        streams = dict(zip(names, arrays))
        u = local_decode(streams)
        return u.reshape(-1, GROUP)

    fn = jax.shard_map(
        sharded_fn, mesh=mesh, in_specs=in_specs, out_specs=P(axis, None),
        check_vma=False,
    )

    patch = df.patch_params
    has_patch = bool(patch and patch["count"])
    # Patch streams travel as trailing ARGUMENTS, never closure captures —
    # the combined-program cache in decode_columns_sharded relies on every
    # piece of data flowing through the argument list.
    pnames = sorted(df.patch_streams) if has_patch else []
    n_main = len(names)

    def full(*arrays):
        u = fn(*arrays[:n_main]).reshape(-1)
        if has_patch:
            ps = dict(zip(pnames, arrays[n_main:]))
            if patch["kind"] == "naive":
                pos = ps["patch_pos"].astype(jnp.int32)
            else:
                from .kernels import delta as k_delta

                pcol = EncodedColumn(
                    name="_ppos", scheme="delta", dtype="int32", n=patch["count"],
                    params={"bits": patch["ppos_bits"]}, streams={},
                )
                pos = k_delta.build(pcol)(
                    {"packed": ps["ppos_packed"], "anchors": ps["ppos_anchors"]}
                )[: patch["count"]].astype(jnp.int32)
            u = u.at[pos].set(ps["patch_val"])
        return u

    return jax.jit(full)


def _device_args(df: DistForm, mesh: Mesh, axis) -> list:
    """Place inputs with their target shardings (replicated streams broadcast
    once here — the column's only communication). Argument order matches
    _build_fn: sorted sharded, sorted replicated, sorted patch streams."""

    def _u32(a):
        return a.view(np.uint32) if a.dtype == np.int32 else a

    args = []
    for k in sorted(df.sharded):
        spec = _spec_for(df.sharded[k], axis, df.bitmap_axis1 and k == "bitmaps")
        args.append(jax.device_put(_u32(df.sharded[k]), NamedSharding(mesh, spec)))
    for k in sorted(df.replicated):
        args.append(jax.device_put(_u32(df.replicated[k]), NamedSharding(mesh, P())))
    if df.patch_params and df.patch_params["count"]:
        for k in sorted(df.patch_streams):
            args.append(jax.device_put(_u32(df.patch_streams[k]), NamedSharding(mesh, P())))
    return args


def decode_sharded(col: EncodedColumn, mesh: Mesh | None = None, axis: str = "d"):
    """One-call sharded decode; returns logical-dtype array of length n
    (NumPy for 64-bit ``wide`` columns — planes decode sharded, the int64
    recombine happens at the host boundary)."""
    from .api import _to_logical

    mesh = mesh or default_mesh(axis)
    if col.scheme == "wide":
        from . import wide

        lo = np.asarray(decode_sharded(wide._sub(col, "lo"), mesh, axis))
        hi = np.asarray(decode_sharded(wide._sub(col, "hi"), mesh, axis))
        return wide._combine(lo.view(np.uint32), hi.view(np.uint32), col.dtype)
    fn, args = build_sharded_decoder(col, mesh, axis)
    u = fn(*args)
    return _to_logical(u, col.dtype)[: col.n]


_SHARDED_COLUMNS_CACHE: dict[tuple, object] = {}


def decode_columns_sharded(
    cols: list[EncodedColumn], mesh: Mesh | None = None, axis: str = "d"
) -> dict:
    """Sharded decode of a whole mixed-column container (BASELINE
    configs[4]) in one jitted program over the mesh. The combined program
    is cached per (columns, mesh) configuration; per-column decoder fns come
    from build_sharded_decoder's own cache, and the combined program is
    rebuilt whenever any of them changed (so it can never close over stale
    fns even if a column's dist form shifts structure for the same static
    key)."""
    from .api import _to_logical

    mesh = mesh or default_mesh(axis)
    built = [build_sharded_decoder(c, mesh, axis) for c in cols]
    fns = tuple(f for f, _ in built)
    args = [a for _, a in built]
    key = (tuple(c.static_key() for c in cols), _mesh_key(mesh, axis))
    cached = _SHARDED_COLUMNS_CACHE.get(key)
    if cached is None or cached[0] != fns:

        @jax.jit
        def run(args_list):
            return [f(*a) for f, a in zip(fns, args_list)]

        cached = (fns, run)
        _cache_put(_SHARDED_COLUMNS_CACHE, key, cached)
    outs = cached[1](args)
    return {c.name: _to_logical(u, c.dtype)[: c.n] for c, u in zip(cols, outs)}
