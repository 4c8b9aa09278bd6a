"""Block-synchronous Pallas wavefront decoder (kernels/wavefront_pallas)
vs the Python oracle — interpret mode on the CPU (SURVEY.md §7.2 #1)."""

import numpy as np
import pytest

from corpus import make_jpeg, pil_decode

from tpujpeg import bitstream, huffman
from tpujpeg.errors import JpegUnsupportedError
from tpujpeg.kernels import wavefront_pallas as wp


CASES = [
    dict(w=64, h=48, subsampling=2),                      # single segment
    dict(w=129, h=65, subsampling=2, restart_blocks=3),   # odd dims
    dict(w=96, h=80, subsampling=0, restart_blocks=2),    # 4:4:4
    dict(w=96, h=80, subsampling=1, restart_blocks=2),    # 4:2:2
    dict(w=64, h=64, subsampling=2, mode="L", restart_blocks=5),
    dict(w=80, h=56, subsampling=2, quality=98, restart_blocks=2),
    dict(w=80, h=56, subsampling=2, quality=25, kind="noise"),
]


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_pallas_wavefront_matches_oracle(case):
    kw = dict(case)
    w, h = kw.pop("w"), kw.pop("h")
    data = make_jpeg(w, h, seed=3, **kw)
    jpeg = bitstream.parse(data)
    ref = huffman.decode_all_scans(jpeg)
    got = wp.decode_all_scans(jpeg)
    for ci, (a, b) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(a, b, err_msg=f"component {ci}")


def test_pallas_wavefront_uniform_batch():
    datas = [
        make_jpeg(120, 88, seed=s, subsampling=2, restart_blocks=4)
        for s in range(3)
    ]
    jpegs = [bitstream.parse(d) for d in datas]
    got, failures = wp.decode_batch_to_device(jpegs, strict=False)
    assert not failures
    for jpeg, comps in zip(jpegs, got):
        ref = huffman.decode_all_scans(jpeg)
        for a, b in zip(ref, comps):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_pallas_wavefront_fault_isolation():
    good = make_jpeg(64, 48, seed=5, subsampling=2, restart_blocks=2)
    jpegs = [bitstream.parse(good), bitstream.parse(good)]
    jpegs[1].scans[0].data = bytes(len(jpegs[1].scans[0].data))
    got, failures = wp.decode_batch_to_device(jpegs, strict=False)
    assert set(failures) == {1}
    ref = huffman.decode_all_scans(jpegs[0])
    for a, b in zip(ref, got[0]):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_pallas_wavefront_rejects_out_of_scope():
    prog = bitstream.parse(
        make_jpeg(64, 64, seed=1, subsampling=2, progressive=True)
    )
    with pytest.raises(JpegUnsupportedError):
        wp.build_block_plan([prog])
    mixed = [
        bitstream.parse(make_jpeg(64, 48, seed=1, subsampling=2)),
        bitstream.parse(make_jpeg(48, 64, seed=1, subsampling=2)),
    ]
    with pytest.raises(JpegUnsupportedError):
        wp.build_block_plan(mixed)


def test_on_device_batch_uses_pallas_path_bit_exact():
    import tpujpeg

    datas = [
        make_jpeg(120, 88, seed=s, subsampling=2, restart_blocks=4)
        for s in range(3)
    ]
    res = tpujpeg.decode_batch_on_device(datas)
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(img, pil_decode(d))


FUSED_CASES = [
    dict(w=120, h=88, subsampling=2, restart_blocks=4),
    dict(w=96, h=64, subsampling=0, restart_blocks=3),
    dict(w=96, h=64, subsampling=1, restart_blocks=3),
    dict(w=96, h=64, subsampling=2, mode="L", restart_blocks=3),
    dict(w=129, h=65, subsampling=2, restart_blocks=3),
    dict(w=96, h=64, subsampling=2, quality=98, restart_blocks=3),
]


@pytest.mark.parametrize(
    "case", FUSED_CASES, ids=[str(i) for i in range(len(FUSED_CASES))]
)
def test_fused_pixels_path_bit_exact(case):
    """decode_batch_to_rgb: wavefront + dequant + IDCT in ONE kernel,
    then fused upsample/color — must equal PIL byte-for-byte."""
    kw = dict(case)
    w, h = kw.pop("w"), kw.pop("h")
    data = make_jpeg(w, h, seed=9, **kw)
    rgb, failures = wp.decode_batch_to_rgb([bitstream.parse(data)])
    assert not failures
    np.testing.assert_array_equal(np.asarray(rgb[0]), pil_decode(data))


def test_fused_pixels_batch_and_fault_isolation():
    good = [
        make_jpeg(120, 88, seed=s, subsampling=2, restart_blocks=4)
        for s in range(2)
    ]
    jpegs = [bitstream.parse(d) for d in good + [good[0]]]
    jpegs[2].scans[0].data = bytes(len(jpegs[2].scans[0].data))
    rgb, failures = wp.decode_batch_to_rgb(jpegs)
    assert set(failures) == {2}
    for i, d in enumerate(good):
        np.testing.assert_array_equal(np.asarray(rgb[i]), pil_decode(d))


def test_fused_pixels_rejects_no_restart_oversize():
    # One 3.5KB segment exceeds MAX_WORDS -> explicit fallback.
    data = make_jpeg(96, 64, seed=9, subsampling=0)
    with pytest.raises(JpegUnsupportedError):
        wp.decode_batch_to_rgb([bitstream.parse(data)])


def test_on_device_batch_mixed_sizes_and_modes():
    """Config-3 shape: mixed geometries bucket into uniform fused
    launches; no-restart images take the fallback path; everything
    bit-exact with failures isolated (BASELINE.json:9)."""
    import tpujpeg

    datas = [
        make_jpeg(120, 88, seed=1, subsampling=2, restart_blocks=4),
        make_jpeg(64, 48, seed=2, subsampling=2, restart_blocks=2),
        make_jpeg(120, 88, seed=3, subsampling=2, restart_blocks=4),
        make_jpeg(96, 64, seed=4, subsampling=0, restart_blocks=3),
        b"broken",
        make_jpeg(64, 48, seed=5, subsampling=2),   # no restart markers
        make_jpeg(96, 64, seed=6, subsampling=2, mode="L", restart_blocks=2),
    ]
    res = tpujpeg.decode_batch_on_device(datas)
    assert set(res.errors) == {4}
    for i, d in enumerate(datas):
        if i == 4:
            continue
        np.testing.assert_array_equal(res.images[i], pil_decode(d), err_msg=str(i))


def test_sharded_fused_decode_over_mesh():
    """Config-3 at multi-chip scale: a uniform batch sharded over the
    device mesh, each device running the fused wavefront+IDCT+color
    program on its chunk under shard_map (SURVEY.md §2.3 DP row)."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    datas = [
        make_jpeg(64, 48, seed=s, subsampling=2, restart_blocks=2)
        for s in range(8)
    ]
    jpegs = [bitstream.parse(d) for d in datas]
    rgb, failures = wp.decode_batch_to_rgb_sharded(jpegs)
    assert not failures
    host = np.asarray(rgb)
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(host[i], pil_decode(d), err_msg=str(i))


def test_fused_pixels_mixed_restart_intervals():
    """Images with different DRIs share one fused launch: the kernel's
    lanes carry per-lane MCU counts, and assembly slices each image to
    its own rows-per-lane (round-2 kernel-scope widening)."""
    datas = [
        make_jpeg(120, 88, seed=1, subsampling=2, restart_blocks=4),
        make_jpeg(120, 88, seed=2, subsampling=2, restart_blocks=2),
        make_jpeg(120, 88, seed=3, subsampling=2, restart_blocks=7),
    ]
    jpegs = [bitstream.parse(d) for d in datas]
    ris = {j.scans[0].restart_interval for j in jpegs}
    assert len(ris) == 3, ris
    rgb, failures = wp.decode_batch_to_rgb(jpegs)
    assert not failures
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(np.asarray(rgb[i]), pil_decode(d))
    # Coefficient mode too.
    got, failures = wp.decode_batch_to_device(jpegs, strict=False)
    assert not failures
    from tpujpeg import huffman as hf
    for jpeg, comps in zip(jpegs, got):
        ref = hf.decode_all_scans(jpeg)
        for a, b in zip(ref, comps):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_fused_pixels_mixed_quantizers():
    """A q85/q92 pair shares one fused launch: the kernel selects each
    lane's dequant constants by one-hot over the batch's quantizer sets
    instead of requiring identical tables."""
    datas = [
        make_jpeg(120, 88, seed=1, subsampling=2, quality=85, restart_blocks=4),
        make_jpeg(120, 88, seed=2, subsampling=2, quality=92, restart_blocks=4),
        make_jpeg(120, 88, seed=3, subsampling=2, quality=85, restart_blocks=4),
    ]
    jpegs = [bitstream.parse(d) for d in datas]
    plan = wp.build_block_plan(jpegs)
    assert len(plan.qsets) == 2
    assert plan.img_qset == (0, 1, 0)
    rgb, failures = wp.decode_batch_to_rgb(jpegs)
    assert not failures
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(np.asarray(rgb[i]), pil_decode(d))


def test_fused_pixels_mixed_quantizers_and_intervals():
    datas = [
        make_jpeg(96, 80, seed=1, subsampling=0, quality=70, restart_blocks=2),
        make_jpeg(96, 80, seed=2, subsampling=0, quality=95, restart_blocks=3),
    ]
    jpegs = [bitstream.parse(d) for d in datas]
    rgb, failures = wp.decode_batch_to_rgb(jpegs)
    assert not failures
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(np.asarray(rgb[i]), pil_decode(d))


def test_norst_device_decode_matches_oracle():
    """Marker-free 512x512 stream (way beyond MAX_WORDS): skeleton
    scan splits it into lanes, kernel decodes with local predictors,
    exclusive-prefix DC fixup recovers the true coefficients."""
    data = make_jpeg(512, 512, seed=5, subsampling=2)
    jpeg = bitstream.parse(data)
    assert len(jpeg.scans[0].rst_offsets) == 0
    from tpujpeg import huffman

    ref = huffman.decode_all_scans(jpeg)
    comps = wp.decode_norst_to_device(jpeg)
    for ci, (a, b) in enumerate(zip(ref, comps)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"comp {ci}")


def test_norst_device_decode_gray_and_444():
    from tpujpeg import huffman

    for kw in (dict(mode="L"), dict(subsampling=0)):
        data = make_jpeg(256, 192, seed=6, **kw)
        jpeg = bitstream.parse(data)
        ref = huffman.decode_all_scans(jpeg)
        comps = wp.decode_norst_to_device(jpeg)
        for a, b in zip(ref, comps):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_norst_full_decode_via_wavefront_engine():
    """decode(entropy='wavefront') on a no-restart stream routes through
    the skeleton-scan device path and matches PIL byte-for-byte."""
    import tpujpeg
    from tpujpeg.config import DecodeConfig

    data = make_jpeg(256, 256, seed=7, subsampling=2)
    img, st = tpujpeg.decode(
        data, DecodeConfig(entropy_engine="wavefront"), return_stats=True
    )
    assert st.entropy_engine == "wavefront"
    np.testing.assert_array_equal(np.asarray(img), pil_decode(data))


def test_norst_truncated_stream_raises():
    from tpujpeg.errors import JpegError

    data = make_jpeg(256, 256, seed=8, subsampling=2)
    jpeg = bitstream.parse(data)
    scan = jpeg.scans[0]
    scan.data = scan.data[: len(scan.data) // 2]
    with pytest.raises(JpegError):
        wp.decode_norst_to_device(jpeg)


def test_huge_restart_interval_segmented_skeleton_decode():
    """Restart-segmented stream whose segments exceed MAX_WORDS:
    the skeleton scan sub-splits each marker segment (every | DRI) and
    the DC prefix fixup resets at marker boundaries — closing the last
    fused-kernel scope gap (VERDICT round 1 #7 item 3)."""
    from tpujpeg import huffman

    data = make_jpeg(512, 512, seed=8, subsampling=2, restart_blocks=256)
    jpeg = bitstream.parse(data)
    assert len(jpeg.scans[0].rst_offsets) >= 2
    with pytest.raises(JpegUnsupportedError):
        wp.build_block_plan([jpeg])  # a segment is over the row cap
    ref = huffman.decode_all_scans(jpeg)
    comps = wp.decode_norst_to_device(jpeg)
    for ci, (a, b) in enumerate(zip(ref, comps)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"comp {ci}")


def test_huge_restart_interval_full_decode_via_engine():
    import tpujpeg
    from tpujpeg.config import DecodeConfig

    data = make_jpeg(320, 256, seed=9, subsampling=0, restart_blocks=128)
    img, st = tpujpeg.decode(
        data, DecodeConfig(entropy_engine="wavefront"), return_stats=True
    )
    assert st.entropy_engine == "wavefront"
    np.testing.assert_array_equal(np.asarray(img), pil_decode(data))


def test_norst_fused_rgb_matches_pil():
    """DC-PRIMED fused pixels path for marker-free streams: the host
    skeleton scan supplies each lane's absolute DC predictors
    (plan.lane_dc0), so the wavefront+IDCT+upsample+color chain runs on
    a stream with no restart markers at all — bit-exact vs PIL."""
    for kw in (dict(subsampling=2), dict(subsampling=1),
               dict(subsampling=0), dict(mode="L")):
        data = make_jpeg(168, 120, seed=21, **kw)
        jpeg = bitstream.parse(data)
        assert len(jpeg.scans[0].rst_offsets) == 0
        plan = wp.build_norst_plan(jpeg)
        assert plan.lane_dc0 is not None and plan.n_lanes > 1
        rgb = wp.decode_norst_to_rgb(jpeg)
        np.testing.assert_array_equal(
            np.asarray(rgb), pil_decode(data), err_msg=str(kw)
        )


def test_norst_fused_rgb_oversize_dri_segments():
    """Restart-segmented stream whose segments exceed MAX_WORDS
    takes the same fused path: sub-split lanes, predictors primed with
    per-marker-segment resets."""
    data = make_jpeg(512, 256, seed=22, subsampling=2, restart_blocks=192)
    jpeg = bitstream.parse(data)
    assert len(jpeg.scans[0].rst_offsets) >= 1
    rgb = wp.decode_norst_to_rgb(jpeg)
    np.testing.assert_array_equal(np.asarray(rgb), pil_decode(data))


def test_norst_fused_rgb_packed16():
    data = make_jpeg(128, 96, seed=23, subsampling=2)
    jpeg = bitstream.parse(data)
    out = wp.decode_norst_to_rgb(jpeg, packed=True)
    want = pil_decode(data)
    got = (
        np.asarray(out)
        .view(np.uint8)
        .reshape(3, want.shape[0], want.shape[1])
        .transpose(1, 2, 0)
    )
    np.testing.assert_array_equal(got, want)


def test_multiscan_baseline_device_coeffs():
    """A baseline image split into per-component scans (T.81 scan
    partition; corpus.make_multiscan_jpeg) decodes on the DEVICE path:
    each scan runs as a single-component wavefront plan and the merged
    coefficients match the python oracle block-for-block."""
    from corpus import make_multiscan_jpeg
    from tpujpeg import huffman

    for rb in (6, 0):  # restart-segmented lanes + skeleton-split lanes
        data = make_multiscan_jpeg(120, 88, seed=3, restart_blocks=rb)
        jpeg = bitstream.parse(data)
        assert len(jpeg.scans) == 3
        ref = huffman.decode_all_scans(jpeg)
        got = wp.decode_all_scans(jpeg)
        for ci, (a, b) in enumerate(zip(ref, got)):
            np.testing.assert_array_equal(a, b, err_msg=f"rb={rb} comp {ci}")


def test_multiscan_baseline_full_decode_exact():
    """Full decode of a multi-scan baseline file through the wavefront
    engine is bit-exact vs PIL."""
    import io

    from PIL import Image

    from corpus import make_multiscan_jpeg
    from tpujpeg.config import DecodeConfig
    import tpujpeg

    data = make_multiscan_jpeg(96, 80, seed=9, subsampling=2,
                               restart_blocks=4)
    img = tpujpeg.decode(data, DecodeConfig(entropy_engine="wavefront"))
    ref = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(np.asarray(img), ref)
