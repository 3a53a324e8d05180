"""Every decode and fused scan is a plain XLA program: no Pallas call in its
jaxpr, and no loop or custom call in the program JAX hands to XLA (an
interpreted grid lowers to a while loop; a compiled kernel to a custom
call)."""

import os

import jax
import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu import aggregate, groupby, query, topk
from giddy_tpu.api import device_streams, get_decoder
from giddy_tpu.datagen import CORE_SCHEMES, gen_column
from giddy_tpu.util import GROUP


def _primitives(jaxpr) -> set[str]:
    names = set()
    for eqn in jaxpr.eqns:
        names.add(eqn.primitive.name)
        for p in eqn.params.values():
            for sub in p if isinstance(p, (list, tuple)) else (p,):
                sub = getattr(sub, "jaxpr", sub)  # ClosedJaxpr -> Jaxpr
                if hasattr(sub, "eqns"):
                    names |= _primitives(sub)
    return names


def _assert_plain(text: str) -> None:
    assert "stablehlo.while" not in text, "a loop in the lowered program"
    assert "custom_call" not in text, "a custom call in the lowered program"


@pytest.fixture
def lowered(tmp_path):
    """Run ``fn`` with JAX's IR dump on and return the text of every
    program lowered meanwhile (caches cleared first, so nothing is
    skipped as already compiled)."""

    def run(fn):
        jax.clear_caches()
        prev = jax.config.read("jax_dump_ir_to")
        jax.config.update("jax_dump_ir_to", str(tmp_path))
        try:
            fn()
        finally:
            jax.config.update("jax_dump_ir_to", prev)
        files = sorted(tmp_path.iterdir())
        assert files, "nothing was lowered"
        return "".join(f.read_text() for f in files)

    return run


@pytest.mark.parametrize("scheme", CORE_SCHEMES)
def test_decoder_is_plain_xla(scheme):
    rng = np.random.default_rng(0)
    col = gt.encode(gen_column(scheme, 2 * GROUP + 17, rng), scheme)
    fn = get_decoder(col)
    streams = device_streams(col)
    prims = _primitives(jax.make_jaxpr(fn)(streams).jaxpr)
    assert not any("pallas" in p for p in prims), prims
    _assert_plain(fn.lower(streams).as_text())
    np.testing.assert_array_equal(
        np.asarray(gt.decode(col)).view(np.uint32), gt.decode_ref(col).view(np.uint32)
    )


def _column(scheme: str):
    rng = np.random.default_rng(1)
    v = rng.integers(0, 5000, 2 * GROUP + 5).astype(np.int32)
    return v, gt.encode(v, scheme)


SCANS = ("nbit", "for", "dzbf")


@pytest.mark.parametrize("scheme", SCANS)
def test_filter_bitmap_is_plain(scheme, lowered):
    v, col = _column(scheme)
    out = {}
    _assert_plain(lowered(lambda: out.update(bm=np.asarray(query.filter_bitmap(col, "lt", 2500)))))
    assert query.count_bits(out["bm"], col.n) == int((v < 2500).sum())


@pytest.mark.parametrize("scheme", SCANS)
def test_count_where_is_plain(scheme, lowered):
    v, col = _column(scheme)
    out = {}
    _assert_plain(lowered(lambda: out.update(c=query.count_where(col, "ge", 1234))))
    assert out["c"] == int((v >= 1234).sum())


@pytest.mark.parametrize("agg", ("sum_", "min_", "max_"))
@pytest.mark.parametrize("scheme", SCANS)
def test_aggregate_is_plain(scheme, agg, lowered):
    v, col = _column(scheme)
    out = {}
    _assert_plain(lowered(lambda: out.update(r=getattr(aggregate, agg)(col))))
    want = {"sum_": int(v.astype(np.int64).sum()), "min_": int(v.min()), "max_": int(v.max())}
    assert out["r"] == want[agg]


@pytest.mark.parametrize("scheme", SCANS)
def test_group_reduce_is_plain(scheme, lowered):
    v, col = _column(scheme)
    keys = (v % 11).astype(np.int32)
    kcol = gt.encode(keys, "dict")
    out = {}
    _assert_plain(lowered(lambda: out.update(r=groupby.group_reduce(kcol, col, aggs=("count", "sum")))))
    r = out["r"]
    for i, k in enumerate(np.asarray(r.keys)):
        m = keys == int(k)
        assert int(r.count[i]) == int(m.sum())
        assert int(r.sum[i]) == int(v[m].astype(np.int64).sum())


@pytest.mark.parametrize("scheme", SCANS)
def test_top_k_is_plain(scheme, lowered):
    v, col = _column(scheme)
    out = {}
    _assert_plain(lowered(lambda: out.update(r=topk.top_k(col, 4))))
    np.testing.assert_array_equal(np.asarray(out["r"][0]), np.sort(v)[::-1][:4])


def test_no_pallas_left_in_the_package():
    """The package imports nothing from Pallas."""
    import giddy_tpu

    root = os.path.dirname(giddy_tpu.__file__)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "jax.experimental.pallas" not in text, f
