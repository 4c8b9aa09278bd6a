"""Distributed paths on the 8-virtual-device CPU mesh (SURVEY.md §4
"Distributed" row): sharded output must equal single-device output and
PIL, and the collectives must implement their contracts."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from corpus import make_jpeg, pil_decode

import tpujpeg
from tpujpeg.config import DecodeConfig
from tpujpeg.parallel import halo


@pytest.fixture
def eight_devices():
    """Skips unless the backend has 8 devices (decided when the test
    runs, never at import: xdist workers must all collect one list)."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")


def test_decode_sharded_matches_pil(eight_devices):
    # 4:2:0, mcus_y = 256/16 = 16 rows -> 8 shards x 2 MCU rows, with
    # h2v2 halo exchange at every shard boundary.
    data = make_jpeg(192, 256, seed=21, subsampling=2)
    out = halo.decode_sharded(data, n_shards=8)
    np.testing.assert_array_equal(out, pil_decode(data))


def test_decode_sharded_422_and_444(eight_devices):
    for ss in (1, 0):
        data = make_jpeg(128, 128, seed=22, subsampling=ss)
        out = halo.decode_sharded(data, n_shards=8)
        np.testing.assert_array_equal(out, pil_decode(data))


def test_decode_sharded_non_divisible_rows_pads(eight_devices):
    # 9 MCU rows on 8 shards: the row count is padded to 16 so all 8
    # devices stay in the ring (no silent shard-count decrement), and
    # the padding never leaks into the cropped output.
    data = make_jpeg(96, 144, seed=23, subsampling=2)
    out = halo.decode_sharded(data, n_shards=8)
    np.testing.assert_array_equal(out, pil_decode(data))


def test_decode_sharded_pad_rows_bottom_edge_exact():
    # The true bottom edge must still upsample with edge replication
    # when the shard below it is pure padding: heights that end mid-MCU
    # exercise the dheight clamp + bottom_edge_shard halo fallback.
    for h in (81, 95, 103):
        data = make_jpeg(80, h, seed=h, subsampling=2)
        out = halo.decode_sharded(data, n_shards=4)
        np.testing.assert_array_equal(out, pil_decode(data))


def test_dc_prefix_fixup_contract(eight_devices):
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    n = 8
    mesh = jax.make_mesh((n,), ("rows",))

    def fixup(local):
        return halo.dc_prefix_fixup(local[0], "rows")[None]

    fx = jax.jit(
        shard_map(
            fixup, mesh=mesh, in_specs=P("rows", None),
            out_specs=P("rows", None), check_vma=False,
        )
    )
    totals = jnp.arange(n * 3, dtype=jnp.int32).reshape(n, 3)
    fixed = np.asarray(fx(totals))
    expect = np.cumsum(np.asarray(totals), axis=0) - np.asarray(totals)
    np.testing.assert_array_equal(fixed, expect)


def test_decode_batch_sharded_matches_pil(eight_devices):
    datas = [make_jpeg(96, 64, seed=s, subsampling=2) for s in range(8)]
    res = tpujpeg.decode_batch(datas, DecodeConfig())
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(img, pil_decode(d))


def test_decode_sharded_with_device_wavefront_entropy(eight_devices):
    """Config 5 end-to-end on-device: wavefront kernel entropy decode
    feeds the MCU-row-sharded transform with halo exchange between devices."""
    data = make_jpeg(192, 256, seed=31, subsampling=2, restart_blocks=4)
    out = halo.decode_sharded(data, n_shards=8)
    np.testing.assert_array_equal(out, pil_decode(data))


def test_norst_sharded_entropy_with_dc_fixup(eight_devices):
    """A marker-free stream decodes via device entropy sharded over the
    mesh; the cross-shard DC-predictor base MUST travel through
    halo.dc_prefix_fixup (its first real caller — VERDICT round 1 #6)."""
    from tpujpeg.kernels import wavefront_pallas as wp

    data = make_jpeg(320, 256, seed=31, subsampling=2)  # no restarts
    jpeg = __import__("tpujpeg").bitstream.parse(data)
    assert len(jpeg.scans[0].rst_offsets) == 0

    calls = []
    orig = halo.dc_prefix_fixup

    def spy(local_totals, axis):
        calls.append(axis)
        return orig(local_totals, axis)

    halo.dc_prefix_fixup = spy
    try:
        comps = wp.decode_norst_sharded(jpeg)
    finally:
        halo.dc_prefix_fixup = orig
    assert calls, "dc_prefix_fixup was not invoked"

    from tpujpeg import huffman
    ref = huffman.decode_all_scans(jpeg)
    for a, b in zip(ref, comps):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_decode_sharded_no_restart_full_image(eight_devices):
    """decode_sharded end-to-end on a marker-free 4:2:0 image: entropy
    sharded by lanes (skeleton scan + DC fixup), transform sharded by
    MCU rows with the halo exchange — bit-exact vs PIL."""
    data = make_jpeg(160, 128, seed=37, subsampling=2)
    out = halo.decode_sharded(data, n_shards=8)
    np.testing.assert_array_equal(out, pil_decode(data))


def test_decode_sharded_huge_restart_interval(eight_devices):
    """Giant-image path with oversize restart segments: entropy goes
    through the segmented skeleton split, transform stays row-sharded."""
    data = make_jpeg(160, 160, seed=41, subsampling=2, restart_blocks=200)
    out = halo.decode_sharded(data, n_shards=4)
    np.testing.assert_array_equal(out, pil_decode(data))


def test_batch_on_device_norst_routes_fused_skeleton():
    """Marker-free baseline images in decode_batch_on_device take the
    per-image DC-primed fused chain (engine wavefront-skeleton) rather
    than coeff mode + separate transform — and stay bit-exact."""
    datas = [make_jpeg(256, 160, seed=s, subsampling=2) for s in (31, 32)]
    res = tpujpeg.decode_batch_on_device(datas)
    assert not res.errors
    assert {s.entropy_engine for s in res.stats if s} == {
        "wavefront-skeleton"
    }
    for i, d in enumerate(datas):
        assert np.array_equal(np.asarray(res.images[i]), pil_decode(d))


def test_batch_on_device_big_norst_progressive_host_fallback():
    """A progressive scan with NO restart segmentation and an oversize
    payload is outside the device scan kernels' scope: it must fall back
    to host entropy inside decode_batch_on_device (valid files never
    fail), bit-exact."""
    data = make_jpeg(512, 384, seed=33, subsampling=2, progressive=True,
               kind="noise")
    from tpujpeg import bitstream

    jpeg = bitstream.parse(data)
    assert all(len(s.rst_offsets) == 0 for s in jpeg.scans)
    assert any(len(s.data) > 2040 for s in jpeg.scans)
    res = tpujpeg.decode_batch_on_device([data])
    assert not res.errors, res.errors
    assert np.array_equal(np.asarray(res.images[0]), pil_decode(data))
