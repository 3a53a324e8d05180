"""Device encode vs host oracle: bit-identical streams."""

import numpy as np
import pytest

import giddy_tpu as gt
from giddy_tpu.kernels import encode as kenc
from giddy_tpu.ref import delta as ref_delta
from giddy_tpu.ref.lmp import lmp_pack
from giddy_tpu.util import GROUP, pad_to_groups


@pytest.mark.parametrize("bits", [1, 9, 17, 32])
def test_device_pack_matches_host(bits):
    rng = np.random.default_rng(bits)
    hi = (1 << bits) - 1 if bits < 32 else 2**32 - 1
    v = rng.integers(0, hi + 1, 2 * GROUP + 5, dtype=np.uint64).astype(np.uint32)
    host = lmp_pack(v, bits)
    col = kenc.encode_nbit_device(v.view(np.int32), bits=bits)
    np.testing.assert_array_equal(col.streams["packed"], host)
    # and the standard decode path accepts the device-encoded column
    np.testing.assert_array_equal(
        np.asarray(gt.decode(col)).view(np.uint32), v
    )


def test_device_for_streams_match_host():
    import jax.numpy as jnp

    from giddy_tpu.ref import for_ as ref_for

    rng = np.random.default_rng(2)
    v = (np.int32(1_700_000_000) + rng.integers(0, 4096, 2 * GROUP)).astype(np.int32)
    host_col = ref_for.encode(v)
    bits, fl = host_col.params["bits"], host_col.params["frame_len"]
    packed, refs = kenc.for_streams_device(jnp.asarray(v.view(np.uint32)), bits, fl)
    np.testing.assert_array_equal(np.asarray(packed), host_col.streams["packed"].view(np.uint32))
    np.testing.assert_array_equal(np.asarray(refs).view(np.int32), host_col.streams["refs"])


def test_device_delta_streams_match_host():
    rng = np.random.default_rng(0)
    v = (np.cumsum(rng.integers(0, 16, 3 * GROUP + 11)) + 1_600_000_000).astype(np.int32)
    host_col = ref_delta.encode(v)
    bits = host_col.params["bits"]
    import jax.numpy as jnp

    u = pad_to_groups(v.view(np.uint32))
    packed, anchors = kenc.delta_streams_device(jnp.asarray(u), bits, n=v.shape[0])
    np.testing.assert_array_equal(np.asarray(packed), host_col.streams["packed"].view(np.uint32))
    np.testing.assert_array_equal(
        np.asarray(anchors).view(np.int32), host_col.streams["anchors"]
    )


def test_device_rle_streams_match_host():
    from giddy_tpu.ref import rle as ref_rle

    rng = np.random.default_rng(4)
    for n in (2 * GROUP, 3 * GROUP + 421, 177, 1):
        v = np.repeat(
            rng.integers(-50, 50, n // 40 + 1).astype(np.int32), 40
        )[:n]
        host_col = ref_rle.encode(v)
        dev_col = kenc.encode_rle_device(v)
        assert dev_col.params["r_pad"] == host_col.params["r_pad"], n
        for s in ("run_values", "run_ends", "run_counts"):
            np.testing.assert_array_equal(
                dev_col.streams[s], host_col.streams[s], err_msg=f"{s} n={n}"
            )
        np.testing.assert_array_equal(np.asarray(gt.decode(dev_col)), v)


def test_device_rle_adversarial_runs():
    from giddy_tpu.ref import rle as ref_rle

    # all-distinct (runs of length 1) and all-equal (one run per group)
    n = GROUP + 17
    for v in (np.arange(n, dtype=np.int32), np.full(n, -7, np.int32)):
        host_col = ref_rle.encode(v)
        dev_col = kenc.encode_rle_device(v)
        for s in ("run_values", "run_ends", "run_counts"):
            np.testing.assert_array_equal(dev_col.streams[s], host_col.streams[s])


def test_device_dict_matches_host():
    from giddy_tpu.ref import dict_ as ref_dict

    rng = np.random.default_rng(5)
    n = 2 * GROUP + 33
    vocab = (np.arange(37, dtype=np.int32) * 11) - 70
    v = vocab[rng.integers(0, 37, n)]
    host_col = ref_dict.encode(v)
    dev_col = kenc.encode_dict_device(v)
    assert dev_col.params == host_col.params
    np.testing.assert_array_equal(dev_col.streams["codes"], host_col.streams["codes"])
    np.testing.assert_array_equal(dev_col.streams["values"], host_col.streams["values"])
    np.testing.assert_array_equal(np.asarray(gt.decode(dev_col)), v)
