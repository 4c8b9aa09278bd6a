"""Device-chain transform correctness (SURVEY.md §4 unit rows): the
batched transform the fused chains end in (kernels/pipeline) must match
PIL end-to-end, and the matmul IDCT must stay inside its tolerance."""

import numpy as np
import pytest

import jax.numpy as jnp

from corpus import make_jpeg, pil_decode

from tpujpeg import bitstream, transform
from tpujpeg.config import DecodeConfig
from tpujpeg.decoder import decode
from tpujpeg.kernels import pipeline as pipe_k


def test_idct_matmul_conformance():
    """Matmul variant: IEEE-1180-style tolerance vs the exact islow path
    (off-by-one rounding allowed on a tiny fraction of samples).
    Coefficients are forward-DCT'd real pixel blocks, so dequantized
    magnitudes stay in the range a conforming JPEG stream can produce
    (T.81 sample domain), unlike unconstrained random int32s."""
    r = np.random.default_rng(78)
    pix = r.integers(0, 256, size=(300, 8, 8)).astype(np.float64) - 128
    c = np.zeros((8, 8))
    for u in range(8):
        a = np.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            c[u, x] = a * np.cos((2 * x + 1) * u * np.pi / 16.0)
    freq = np.einsum("ux,vy,nxy->nuv", c, c, pix)  # forward 2-D DCT
    qtab = r.integers(1, 64, size=(64,)).astype(np.int32)
    qnat = qtab[np.asarray(bitstream.NATURAL_TO_ZIGZAG)].reshape(8, 8)
    quant = np.round(freq / qnat).astype(np.int32).reshape(300, 64)
    coeffs = quant[:, np.asarray(bitstream.ZIGZAG)]  # back to zigzag order
    ref = np.asarray(
        transform.idct8x8_islow(
            transform.dequantize(jnp.asarray(coeffs), jnp.asarray(qtab))
        )
    ).astype(np.int32)
    got = np.asarray(
        transform.dequant_idct_matmul(jnp.asarray(coeffs), jnp.asarray(qtab))
    ).astype(np.int32)
    diff = np.abs(ref - got)
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.05


PIPE_CASES = [
    dict(w=120, h=88, subsampling=2),   # h2v2, odd-ish dims
    dict(w=64, h=48, subsampling=1),    # h2v1
    dict(w=80, h=80, subsampling=0),    # 444
    dict(w=56, h=56, subsampling=2, mode="L"),  # grayscale
]


@pytest.mark.parametrize("case", PIPE_CASES, ids=["420", "422", "444", "gray"])
def test_pipeline_bit_exact_vs_pil(case):
    from tpujpeg.native import entropy as ne

    kw = dict(case)
    w, h = kw.pop("w"), kw.pop("h")
    data = make_jpeg(w, h, seed=11, **kw)
    jpeg = bitstream.parse(data)
    coeffs = ne.decode_all_scans(jpeg)
    out = pipe_k.transform_batch(
        jpeg.frame, [c[None] for c in coeffs],
        [jpeg.qtables[c.tq] for c in jpeg.frame.components], DecodeConfig(),
        color=bitstream.color_space(jpeg),
    )
    np.testing.assert_array_equal(np.asarray(out[0]), pil_decode(data))


def test_pipeline_matmul_idct_close_to_pil():
    data = make_jpeg(96, 64, seed=12, subsampling=2)
    out = decode(data, DecodeConfig(idct="matmul")).astype(np.int32)
    ref = pil_decode(data).astype(np.int32)
    # Color conversion amplifies a +-1 IDCT LSB slightly; stay tight.
    assert np.abs(out - ref).max() <= 3
    assert (out != ref).mean() < 0.2


def test_batched_pipeline_matches_single():
    """One bucket, one dispatch: the batched path must equal per-image
    decode and PIL for mixed content (SURVEY.md §3.5)."""
    import tpujpeg

    datas = [
        make_jpeg(120, 88, seed=s, subsampling=2, kind=k)
        for s, k in [(1, "photo"), (2, "noise"), (3, "flat")]
    ]
    res = tpujpeg.decode_batch(datas, DecodeConfig())
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(img, pil_decode(d))


def test_batched_pipeline_fault_isolation():
    import tpujpeg

    datas = [
        make_jpeg(64, 48, seed=1, subsampling=2),
        b"not a jpeg",
        make_jpeg(64, 48, seed=2, subsampling=2),
    ]
    res = tpujpeg.decode_batch(datas, DecodeConfig())
    assert set(res.errors) == {1}
    np.testing.assert_array_equal(res.images[0], pil_decode(datas[0]))
    np.testing.assert_array_equal(res.images[2], pil_decode(datas[2]))
    assert res.images[1] is None


def test_batched_progressive_via_native_entropy():
    """Progressive files in a batch: host native entropy (all four scan
    kinds) + batched device transform, bit-exact."""
    import tpujpeg

    datas = [
        make_jpeg(120, 88, seed=s, subsampling=2, progressive=True)
        for s in range(3)
    ]
    res = tpujpeg.decode_batch(datas, DecodeConfig())
    assert not res.errors
    for d, img in zip(datas, res.images):
        np.testing.assert_array_equal(img, pil_decode(d))
