"""Device-side progressive entropy decode (kernels/wavefront_prog) vs
the Python oracle and PIL (SURVEY.md §2.1 #10, §3.3). All four T.81 §G
scan kinds run on device over restart-segment lanes; interpret mode on
CPU here, the same code compiled for the GPU."""

import io

import numpy as np
import pytest
from PIL import Image

from corpus import make_jpeg, pil_decode

import tpujpeg
from tpujpeg import bitstream, huffman
from tpujpeg.config import DecodeConfig
from tpujpeg.errors import JpegError
from tpujpeg.kernels import wavefront_prog as wprog


CASES = [
    dict(w=128, h=96, subsampling=2, restart_blocks=8),
    dict(w=96, h=96, subsampling=0, restart_blocks=4),
    dict(w=120, h=88, subsampling=1, restart_blocks=6),
    dict(w=96, h=64, mode="L", restart_blocks=8),
    dict(w=129, h=65, subsampling=2, restart_blocks=3),   # odd dims
    dict(w=80, h=56, subsampling=2, quality=95, restart_blocks=2),
    dict(w=80, h=56, subsampling=2, quality=25, restart_blocks=4,
         kind="noise"),
]


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_prog_device_matches_oracle(case):
    kw = dict(case)
    w, h = kw.pop("w"), kw.pop("h")
    data = make_jpeg(w, h, seed=13, progressive=True, **kw)
    jpeg = bitstream.parse(data)
    assert jpeg.frame.progressive
    ref = huffman.decode_all_scans(jpeg)
    acs, dcs = wprog.decode_all_scans(jpeg)
    for ci, (a, b, d) in enumerate(zip(ref, acs, dcs)):
        merged = np.array(b)
        merged[:, 0] = np.asarray(d)
        np.testing.assert_array_equal(a, merged, err_msg=f"comp {ci}")


def test_prog_device_scan_kinds_present():
    """The generated corpus must actually exercise all four scan kinds,
    or the parametrized test above proves less than it claims."""
    data = make_jpeg(128, 96, seed=13, progressive=True, subsampling=2,
                     restart_blocks=8)
    jpeg = bitstream.parse(data)
    kinds = set()
    for s in jpeg.scans:
        kinds.add(
            ("dc" if s.ss == 0 else "ac") + ("_refine" if s.ah else "_first")
        )
    assert kinds == {"dc_first", "dc_refine", "ac_first", "ac_refine"}, kinds


def test_prog_device_full_decode_via_engine():
    data = make_jpeg(128, 96, seed=21, progressive=True, subsampling=2,
                     restart_blocks=8)
    img, st = tpujpeg.decode(
        data, DecodeConfig(entropy_engine="wavefront"), return_stats=True
    )
    assert st.entropy_engine == "wavefront"
    assert st.entropy_fallbacks == 0
    np.testing.assert_array_equal(np.asarray(img), pil_decode(data))


def test_prog_device_truncated_scan_raises():
    data = make_jpeg(128, 96, seed=22, progressive=True, subsampling=2,
                     restart_blocks=8)
    jpeg = bitstream.parse(data)
    s = jpeg.scans[1]
    s.data = s.data[: len(s.data) // 3]
    s.rst_offsets = [o for o in s.rst_offsets if o < len(s.data)]
    with pytest.raises(JpegError):
        wprog.decode_all_scans(jpeg)


def test_prog_device_corrupt_scan_raises_or_detects():
    data = make_jpeg(96, 96, seed=23, progressive=True, subsampling=2,
                     restart_blocks=8)
    jpeg = bitstream.parse(data)
    # Zero a whole scan's entropy bytes: must raise, never hang/crash.
    s = jpeg.scans[2]
    s.data = bytes(len(s.data))
    try:
        acs, dcs = wprog.decode_all_scans(jpeg)
        # All-zero bits can still be a decodable (wrong) stream; the
        # contract is defined behavior, not a mandatory error.
        for g in list(acs) + list(dcs):
            np.asarray(g)
    except JpegError:
        pass


def test_batch_on_device_mixed_progressive_and_baseline():
    """decode_batch_on_device routes progressive members through the
    device scan kernels and baseline members through the fused path."""
    datas = [
        make_jpeg(96, 80, seed=1, subsampling=2, restart_blocks=4),
        make_jpeg(96, 80, seed=2, subsampling=2, progressive=True,
                  restart_blocks=8),
        make_jpeg(64, 64, seed=3, mode="L", progressive=True,
                  restart_blocks=4),
    ]
    res = tpujpeg.decode_batch_on_device(datas)
    assert not res.errors
    engines = [s.entropy_engine for s in res.stats if s]
    assert "wavefront-prog" in engines and "wavefront-fused" in engines
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(
            np.asarray(img), np.asarray(Image.open(io.BytesIO(d)))
        )


def test_prog_batch_matches_oracle_shared_tables():
    """Cross-image batched scans: a group whose members share tables
    (libjpeg emits per-image OPTIMIZED tables for progressive, so in
    practice that means duplicated assets or fixed-table encoders)
    decodes in shared launches, each member bit-exact vs the oracle.
    Members are parsed separately so lane plumbing — not object
    identity — carries the result."""
    data = make_jpeg(128, 96, seed=31, progressive=True, subsampling=2,
                     restart_blocks=8)
    jpegs = [bitstream.parse(data) for _ in range(3)]
    assert len({wprog.scan_group_key(j) for j in jpegs}) == 1
    states, dcs, failures = wprog.decode_all_scans_batch(jpegs)
    assert not failures
    ref = huffman.decode_all_scans(jpegs[0])
    for i in range(3):
        for ci, (a, b, d) in enumerate(zip(ref, states[i], dcs[i])):
            merged = np.array(b)
            merged[:, 0] = np.asarray(d)
            np.testing.assert_array_equal(
                a, merged, err_msg=f"img {i} comp {ci}"
            )


def test_prog_to_rgb_merged_chain_bit_exact():
    """decode_all_scans_to_rgb_batch: the ONE-dispatch chain (scan
    kernels + DC merges + transform) matches PIL bit-for-bit in the
    packed16 layout (the bench form; the nhwc form is exercised by the
    batch-ladder tests, which route progressive groups through the
    same merged chain)."""
    data = make_jpeg(168, 120, seed=33, progressive=True, subsampling=2,
                     restart_blocks=4)
    jpegs = [bitstream.parse(data) for _ in range(2)]
    cfg = DecodeConfig()
    ref = np.asarray(Image.open(io.BytesIO(data)))
    rgbp, layoutp, failp = wprog.decode_all_scans_to_rgb_batch(
        jpegs, cfg, packed=True
    )
    assert layoutp == "packed16" and not failp
    for i in range(2):
        u8 = np.asarray(rgbp[i]).view(np.uint8).reshape(
            3, ref.shape[0], ref.shape[1]
        )
        np.testing.assert_array_equal(u8.transpose(1, 2, 0), ref)


def test_transform_batch_per_image_quantizers():
    """pipeline.transform_batch with qtabs[ci] = [N, 64] (one quantizer
    per image): XLA-side per-image dequant is bit-exact vs PIL for a
    q85/q70 pair sharing one launch."""
    from tpujpeg.kernels import pipeline as kp
    from tpujpeg.native import entropy as ne
    import jax.numpy as jnp

    d1 = make_jpeg(168, 120, seed=21, quality=85, subsampling=2,
                   restart_blocks=3)
    d2 = make_jpeg(168, 120, seed=22, quality=70, subsampling=2,
                   restart_blocks=3)
    jpegs = [bitstream.parse(d) for d in (d1, d2)]
    frame = jpegs[0].frame
    coeffs = [ne.decode_all_scans(j) for j in jpegs]
    coeff_stack = [
        jnp.stack([np.asarray(coeffs[i][ci]) for i in range(2)])
        for ci in range(3)
    ]
    qtabs = [
        jnp.asarray(np.stack([j.qtables[c.tq] for j in jpegs]))
        for c in frame.components
    ]
    cfg = DecodeConfig()
    rgb = kp.transform_batch(frame, coeff_stack, qtabs, cfg,
                             color="ycbcr")
    for i, d in enumerate((d1, d2)):
        np.testing.assert_array_equal(
            np.asarray(rgb[i]),
            np.asarray(Image.open(io.BytesIO(d))),
        )


def test_prog_batch_per_image_tables_split_groups():
    """Different-content progressive files carry per-image optimized
    tables, so they must land in separate groups — and still decode
    correctly through the grouped dispatcher as singletons."""
    datas = [
        make_jpeg(128, 96, seed=31, progressive=True, subsampling=2,
                  restart_blocks=8),
        make_jpeg(128, 96, seed=32, progressive=True, subsampling=2,
                  restart_blocks=8),
    ]
    jpegs = [bitstream.parse(d) for d in datas]
    assert len({wprog.scan_group_key(j) for j in jpegs}) == 2
    res = tpujpeg.decode_batch_on_device(datas)
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(np.asarray(img), pil_decode(d))


def test_prog_batch_bad_image_poisons_only_itself():
    """A corrupted member's lanes error; the other members of the group
    still decode bit-exactly (per-image fault isolation inside one
    launch)."""
    good = make_jpeg(96, 96, seed=51, progressive=True, subsampling=2,
                     restart_blocks=8)
    bad = bytearray(make_jpeg(96, 96, seed=51, progressive=True,
                              subsampling=2, restart_blocks=8))
    jpeg_probe = bitstream.parse(bytes(bad))
    # Zero one AC-first scan's entropy payload in the FILE so both
    # members still parse to the same scan structure.
    target = None
    for s in jpeg_probe.scans:
        if s.ss != 0 and s.ah == 0 and len(s.data) > 64:
            target = s
            break
    assert target is not None
    start = bytes(bad).find(target.data)
    assert start > 0
    bad[start : start + 48] = bytes(48)
    datas = [good, bytes(bad)]
    res = tpujpeg.decode_batch_on_device(datas)
    # The good image must decode exactly regardless of its groupmate.
    np.testing.assert_array_equal(
        np.asarray(res.images[0]), pil_decode(good)
    )
    # The bad one either surfaced an error or produced (wrong) pixels —
    # defined behavior, never a crash or a poisoned neighbor.
    assert (1 in res.errors) or (res.images[1] is not None)


def test_batch_on_device_groups_progressive():
    """Same-structure progressive members decode through the grouped
    path and all come back bit-exact."""
    datas = [
        make_jpeg(96, 80, seed=61 + i, progressive=True, subsampling=2,
                  restart_blocks=8)
        for i in range(3)
    ] + [
        make_jpeg(64, 64, seed=70, mode="L", progressive=True,
                  restart_blocks=4)
    ]
    res = tpujpeg.decode_batch_on_device(datas)
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(np.asarray(img), pil_decode(d))
    assert all(
        s.entropy_engine == "wavefront-prog" for s in res.stats if s
    )


def _bump_dqt(data: bytes, delta: int = 7) -> bytes:
    """Return `data` with every 8-bit DQT entry shifted by `delta`
    (clamped to [1, 255]). Entropy data and Huffman tables are
    untouched, so the result shares scan_group_key with the original
    but carries different quantizers — the per-image-quantizer shared
    launch, unreachable with PIL's per-image optimized tables."""
    out = bytearray(data)
    i = 2
    while i + 4 <= len(out):
        marker = out[i + 1]
        assert out[i] == 0xFF
        if marker == 0xDA:  # SOS: stop before entropy data
            break
        seglen = (out[i + 2] << 8) | out[i + 3]
        if marker == 0xDB:
            j = i + 4
            end = i + 2 + seglen
            while j < end:
                pq = out[j] >> 4
                assert pq == 0, "8-bit tables only in this helper"
                for k in range(j + 1, j + 65):
                    out[k] = max(1, min(255, out[k] + delta))
                j += 65
        i += 2 + seglen
    return bytes(out)


def test_prog_batch_mixed_quantizers_share_group():
    """Identical Huffman tables + different DQTs must share ONE group
    (quantizers are not part of the batch group key; the one-jit chain
    dequantizes per image) and both decode bit-exact vs PIL."""
    base = make_jpeg(96, 80, seed=77, progressive=True, subsampling=2,
                     restart_blocks=8)
    variant = _bump_dqt(base)
    ja, jb = bitstream.parse(base), bitstream.parse(variant)
    assert wprog.scan_group_key(ja) == wprog.scan_group_key(jb)
    assert any(
        not np.array_equal(ja.qtables[c.tq], jb.qtables[c.tq])
        for c in ja.frame.components
    )
    res = tpujpeg.decode_batch_on_device([base, variant])
    assert not res.errors
    for d, img in zip([base, variant], res.images):
        np.testing.assert_array_equal(np.asarray(img), pil_decode(d))


def test_prog_chain_shared_across_table_sets():
    """Huffman tables ride as runtime operands: two files with different
    optimized tables but one scan-script shape map to ONE compiled chain
    (equal jit keys), and each decodes exactly to the oracle through it."""
    datas = [
        make_jpeg(96, 80, seed=s, progressive=True, subsampling=2,
                  restart_blocks=8)
        for s in (91, 92)
    ]
    jpegs = [bitstream.parse(d) for d in datas]
    assert wprog.scan_group_key(jpegs[0]) != wprog.scan_group_key(jpegs[1])
    keys = [wprog._chain_statics([j])[0] for j in jpegs]
    assert keys[0] == keys[1]
    for j in jpegs:
        states, dcs, failures = wprog.decode_all_scans_batch([j])
        assert not failures
        ref = huffman.decode_all_scans(j)
        for ci, (a, b, d) in enumerate(zip(ref, states[0], dcs[0])):
            merged = np.array(b)
            merged[:, 0] = np.asarray(d)
            np.testing.assert_array_equal(a, merged, err_msg=f"comp {ci}")
