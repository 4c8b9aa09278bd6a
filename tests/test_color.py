"""Adobe APP14 / color-space handling (SURVEY.md §2.1 #16; T.81 leaves
color interpretation to JFIF/Adobe conventions, so the contract is
bit-exactness vs PIL/libjpeg on every marker combination):

  * JFIF 3-component        -> YCbCr -> RGB (the default path)
  * Adobe transform=0, RGB component ids -> RGB passthrough
  * Adobe transform=0, 4 components      -> CMYK (PIL 'CMYK;I' polarity)
  * Adobe transform=2, 4 components      -> YCCK -> CMYK
"""

import io

import numpy as np
import pytest
from PIL import Image

import tpujpeg
from tpujpeg import bitstream
from tpujpeg.config import DecodeConfig


def _noise(w, h, ch, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(h, w, ch), dtype=np.uint8)
    # Smooth horizontally so the JPEG has realistic low-frequency content.
    return ((base.astype(np.int32) + np.roll(base, 1, 1) + np.roll(base, 2, 1)) // 3).astype(np.uint8)


def make_cmyk_jpeg(w=96, h=80, seed=0, quality=90):
    im = Image.fromarray(_noise(w, h, 4, seed), mode="CMYK")
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def make_rgb_jpeg(w=96, h=80, seed=0, quality=90):
    im = Image.fromarray(_noise(w, h, 3, seed), mode="RGB")
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=quality, keep_rgb=True)
    return buf.getvalue()


def patch_adobe_transform(data: bytes, transform: int) -> bytes:
    """Rewrite the APP14 Adobe color-transform byte (the final byte of
    the Adobe segment payload) so a CMYK file reads as YCCK or back."""
    i = data.find(b"\xff\xee")
    assert i >= 0, "no APP14 marker"
    length = int.from_bytes(data[i + 2 : i + 4], "big")
    payload = data[i + 4 : i + 2 + length]
    assert payload[:5] == b"Adobe"
    j = i + 2 + length - 1  # last byte of the segment = transform flag
    return data[:j] + bytes([transform]) + data[j + 1 :]


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)))


def _assert_exact(data: bytes, device: bool = False, **cfg_kw):
    """decode() (the staged path on the CPU), or with device=True the
    fused device path through decode_batch_on_device."""
    if device:
        res = tpujpeg.decode_batch_on_device([data], DecodeConfig(**cfg_kw))
        assert not res.errors, res.errors
        got = np.asarray(res.images[0])
    else:
        got = np.asarray(tpujpeg.decode(data, DecodeConfig(**cfg_kw)))
    want = _pil(data)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_color_space_classifier():
    cmyk = bitstream.parse(make_cmyk_jpeg())
    assert bitstream.color_space(cmyk) == "cmyk"
    rgb = bitstream.parse(make_rgb_jpeg())
    assert bitstream.color_space(rgb) == "rgb"
    ycck = bitstream.parse(patch_adobe_transform(make_cmyk_jpeg(), 2))
    assert bitstream.color_space(ycck) == "ycck"


def test_cmyk_bit_exact_jnp():
    _assert_exact(make_cmyk_jpeg(seed=1))


def test_cmyk_bit_exact_pallas():
    _assert_exact(make_cmyk_jpeg(seed=2), device=True)


def test_rgb_passthrough_bit_exact_jnp():
    _assert_exact(make_rgb_jpeg(seed=3))


def test_rgb_passthrough_bit_exact_pallas():
    _assert_exact(make_rgb_jpeg(seed=4), device=True)


def test_ycck_bit_exact():
    # PIL can't *write* YCCK; reinterpret a CMYK file's Adobe flag so
    # both decoders run the YCCK->CMYK conversion on the same scan data.
    data = patch_adobe_transform(make_cmyk_jpeg(seed=5), 2)
    _assert_exact(data)
    _assert_exact(data, device=True)


def test_jfif_beats_component_ids():
    # A JFIF 3-component file stays YCbCr regardless of component ids.
    j = bitstream.parse(make_jfif_420())
    assert j.saw_jfif
    assert bitstream.color_space(j) == "ycbcr"


def make_jfif_420(w=64, h=48, seed=6):
    im = Image.fromarray(_noise(w, h, 3, seed), mode="RGB")
    buf = io.BytesIO()
    im.save(buf, "JPEG", quality=85)  # default: JFIF + YCbCr
    return buf.getvalue()


def test_cmyk_python_engine():
    _assert_exact(
        make_cmyk_jpeg(seed=7), entropy_engine="python"
    )


def test_batch_mixed_color_spaces():
    datas = [
        make_cmyk_jpeg(seed=8),
        make_rgb_jpeg(seed=9),
        make_jfif_420(96, 80, seed=10),
        patch_adobe_transform(make_cmyk_jpeg(seed=11), 2),
    ]
    res = tpujpeg.decode_batch(datas)
    assert not res.errors
    for d, img in zip(datas, res.images):
        assert np.array_equal(img, _pil(d))


def test_batch_on_device_cmyk():
    # Restart-segmented CMYK through the on-device batch path (fused
    # kernel if it takes 4-component 4:4:4, coefficient fallback
    # otherwise — either way the output must match PIL byte-for-byte).
    def make(seed):
        im = Image.fromarray(_noise(64, 64, 4, seed), mode="CMYK")
        buf = io.BytesIO()
        im.save(buf, "JPEG", quality=90, restart_marker_blocks=8)
        return buf.getvalue()

    datas = [make(s) for s in (12, 13)]
    res = tpujpeg.decode_batch_on_device(datas)
    assert not res.errors
    for d, img in zip(datas, res.images):
        assert np.array_equal(np.asarray(img), _pil(d))


@pytest.mark.parametrize("hv", [
    ((1, 2), (1, 1), (1, 1)),   # 4:4:0 — libjpeg-turbo h1v2 FANCY path
    ((4, 1), (1, 1), (1, 1)),   # 4:1:1-style wide luma (replication)
    ((2, 2), (2, 1), (1, 2)),   # mixed: h1v2 + h2v1 chroma
    ((1, 1), (1, 2), (2, 1)),   # subsampled luma vs full chroma
])
def test_exotic_sampling_factors_bit_exact(hv):
    """Sampling-factor combinations PIL cannot ENCODE but libjpeg
    decodes (synthetic coefficient streams, corpus.make_synth_jpeg).
    The h1v2 'fancy' vertical upsampler (libjpeg-turbo's 4:4:0 path)
    was missing until round 5 — replication decoded these wrong."""
    import tpujpeg
    from corpus import make_synth_jpeg, pil_decode

    d = make_synth_jpeg(72, 56, hv=hv, seed=3, restart_blocks=4)
    ref = pil_decode(d)
    for eng in ("native", "wavefront"):
        img = tpujpeg.decode(d, DecodeConfig(entropy_engine=eng))
        np.testing.assert_array_equal(np.asarray(img), ref,
                                      err_msg=f"{hv} {eng}")
