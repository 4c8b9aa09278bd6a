"""Sample-reconstruction stage: dequant + IDCT + upsample + color convert.

SURVEY.md §2.1 components 11-17, expressed as pure vectorized jax.numpy
over *all blocks of a component at once* — the data-parallel
formulation of the reference's per-block OpenCL NDRange kernels
(SURVEY.md §1 L2), which XLA fuses. This module is the semantic ground
truth; the wavefront kernel's fused IDCT epilogue must match it
exactly.

Bit-exactness contract (SURVEY.md §7.2 hard-part 2): every op replicates
libjpeg's fixed-point arithmetic —
  * IDCT: jpeg_idct_islow (Loeffler-class, CONST_BITS=13, PASS1_BITS=2),
    the default (JDCT_ISLOW) path of libjpeg/libjpeg-turbo, so output
    bytes match PIL exactly.
  * Upsampling: h2v1/h2v2 "fancy" (triangular) filters with libjpeg's
    exact rounding, plus replication (int_upsample) for other ratios.
  * Color: ycc_rgb 16-bit fixed-point constants (jdcolor.c semantics).
All arithmetic is int32; right shifts are arithmetic, matching C.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .bitstream import Frame, NATURAL_TO_ZIGZAG, ZIGZAG

# libjpeg jidctint.c fixed-point constants, CONST_BITS = 13.
CONST_BITS = 13
PASS1_BITS = 2
FIX_0_298631336 = 2446
FIX_0_390180644 = 3196
FIX_0_541196100 = 4433
FIX_0_765366865 = 6270
FIX_0_899976223 = 7373
FIX_1_175875602 = 9633
FIX_1_501321110 = 12299
FIX_1_847759065 = 15137
FIX_1_961570560 = 16069
FIX_2_053119869 = 16819
FIX_2_562915447 = 20995
FIX_3_072711026 = 25172


def _descale(x: jnp.ndarray, n: int) -> jnp.ndarray:
    """libjpeg DESCALE: round-half-up arithmetic shift."""
    return (x + (1 << (n - 1))) >> n


def _idct_1d(s, descale_bits: int):
    """One 8-point islow butterfly (jidctint.c structure). `s` is a list
    of 8 int32 arrays (any broadcastable shape); returns 8 arrays."""
    s0, s1, s2, s3, s4, s5, s6, s7 = s

    # Even part.
    z2, z3 = s2, s6
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * (-FIX_1_847759065)
    tmp3 = z1 + z2 * FIX_0_765366865

    z2, z3 = s0, s4
    tmp0 = (z2 + z3) << CONST_BITS
    tmp1 = (z2 - z3) << CONST_BITS

    tmp10 = tmp0 + tmp3
    tmp13 = tmp0 - tmp3
    tmp11 = tmp1 + tmp2
    tmp12 = tmp1 - tmp2

    # Odd part.
    t0, t1, t2, t3 = s7, s5, s3, s1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602

    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * (-FIX_0_899976223)
    z2 = z2 * (-FIX_2_562915447)
    z3 = z3 * (-FIX_1_961570560)
    z4 = z4 * (-FIX_0_390180644)

    z3 = z3 + z5
    z4 = z4 + z5

    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4

    return (
        _descale(tmp10 + t3, descale_bits),
        _descale(tmp11 + t2, descale_bits),
        _descale(tmp12 + t1, descale_bits),
        _descale(tmp13 + t0, descale_bits),
        _descale(tmp13 - t0, descale_bits),
        _descale(tmp12 - t1, descale_bits),
        _descale(tmp11 - t2, descale_bits),
        _descale(tmp10 - t3, descale_bits),
    )


def dequantize(coeffs_zz: jnp.ndarray, qtab_zz: jnp.ndarray) -> jnp.ndarray:
    """coeffs_zz: int32[N, 64] zigzag-order coefficients; qtab_zz:
    int32[64] zigzag-order quantizer. Returns natural-order int32[N,8,8].
    (SURVEY.md §2.1 #11-12: dequant fused with the zigzag gather.)"""
    nat = (coeffs_zz * qtab_zz)[:, NATURAL_TO_ZIGZAG]
    return nat.reshape(-1, 8, 8)


def idct8x8_islow(blocks: jnp.ndarray) -> jnp.ndarray:
    """Batched libjpeg islow IDCT. blocks: int32[N,8,8] natural-order
    *dequantized* coefficients. Returns uint8[N,8,8] samples (level
    shifted +128, clamped) — bit-exact vs jpeg_idct_islow (SURVEY.md
    §2.1 #13)."""
    b = blocks.astype(jnp.int32)
    # Pass 1: process columns; input rows indexed by frequency.
    cols = [b[:, i, :] for i in range(8)]  # each [N, 8(cols)]
    ws = _idct_1d(cols, CONST_BITS - PASS1_BITS)
    # Pass 2: process rows of the workspace. ws[r] is output spatial row r
    # as [N, 8]; the 1-D transform now runs across those 8 values.
    out_rows = []
    for r in range(8):
        row = ws[r]  # [N, 8] frequencies along axis 1
        s = [row[:, i] for i in range(8)]
        o = _idct_1d(s, CONST_BITS + PASS1_BITS + 3)
        out_rows.append(jnp.stack(o, axis=-1))  # [N, 8]
    out = jnp.stack(out_rows, axis=1)  # [N, 8, 8]
    return jnp.clip(out + 128, 0, 255).astype(jnp.uint8)


@functools.lru_cache(maxsize=None)
def _idct_matrix_zz() -> np.ndarray:
    """M[k, n]: contribution of zigzag coefficient k to natural pixel n,
    i.e. the 64x64 Kronecker IDCT basis with the zigzag permutation
    folded into the rows (so inputs stay in zigzag order)."""
    c = np.zeros((8, 8), dtype=np.float64)  # c[u, x] = basis
    for u in range(8):
        a = np.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            c[u, x] = a * np.cos((2 * x + 1) * u * np.pi / 16.0)
    # pixel (x, y) = sum_{u,v} C[u,x] C[v,y] F[u,v];  natural n = x*8+y,
    # natural freq m = u*8+v -> M_nat[m, n] = C[u,x]*C[v,y].
    m_nat = np.einsum("ux,vy->uvxy", c, c).reshape(64, 64)
    return m_nat[np.asarray(ZIGZAG)].astype(np.float32)


def dequant_idct_matmul(coeffs_zz: jnp.ndarray, qtab_zz) -> jnp.ndarray:
    """config idct='matmul': dequant + zigzag + IDCT as one
    [N, 64] @ [64, 64] float32 product. int32[N, 64] zigzag coeffs ->
    uint8[N, 8, 8]. A float basis against libjpeg's fixed point, so not
    bit-exact: at most 1 LSB off on a small share of samples. The
    product runs at HIGHEST precision — TF32 would keep only about three
    decimal digits and break that bound."""
    m = jnp.asarray(_idct_matrix_zz())
    deq = (coeffs_zz * qtab_zz).astype(jnp.float32)
    pix = jax.lax.dot_general(
        deq, m, (((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    out = jnp.round(pix) + 128
    return jnp.clip(out, 0, 255).astype(jnp.uint8).reshape(-1, 8, 8)


def blocks_to_plane(samples: jnp.ndarray, padded_hb: int, padded_wb: int) -> jnp.ndarray:
    """[padded_hb*padded_wb, 8, 8] block samples → [padded_hb*8, padded_wb*8]
    raster plane (SURVEY.md §2.1 #17 MCU assembly, done as one reshape)."""
    x = samples.reshape(padded_hb, padded_wb, 8, 8)
    return x.transpose(0, 2, 1, 3).reshape(padded_hb * 8, padded_wb * 8)


# ---------------------------------------------------------------------------
# Upsampling (jdsample.c semantics) — SURVEY.md §2.1 #15
# ---------------------------------------------------------------------------


def _h2_fancy_cols(
    cs: jnp.ndarray, bits: int, bias_even: int, bias_odd: int
) -> jnp.ndarray:
    """Horizontal ×2 triangular upsample of per-column sums `cs` [.., W]
    → [.., 2W]: even outputs (3·this + prev + bias_even) >> bits, odd
    (3·this + next + bias_odd) >> bits. Edge clamping reproduces
    libjpeg's first/last-column special cases exactly. Note the bias
    convention differs between jdsample.c's h2v1 (1, 2) and h2v2 (8, 7)
    filters — verified bit-exactly against libjpeg-turbo via PIL."""
    left = jnp.concatenate([cs[..., :1], cs[..., :-1]], axis=-1)
    right = jnp.concatenate([cs[..., 1:], cs[..., -1:]], axis=-1)
    even = (3 * cs + left + bias_even) >> bits
    odd = (3 * cs + right + bias_odd) >> bits
    out = jnp.stack([even, odd], axis=-1)
    return out.reshape(*cs.shape[:-1], cs.shape[-1] * 2)


def upsample_h2v1_fancy(plane: jnp.ndarray) -> jnp.ndarray:
    """h2v1_fancy_upsample: [H, W] → [H, 2W]."""
    return _h2_fancy_cols(
        plane.astype(jnp.int32), bits=2, bias_even=1, bias_odd=2
    ).astype(jnp.uint8)


def upsample_h2v2_fancy(plane: jnp.ndarray) -> jnp.ndarray:
    """h2v2_fancy_upsample: [H, W] → [2H, 2W]. Output row 2r blends input
    row r (×3) with r-1; row 2r+1 blends r with r+1; edges replicate."""
    p = plane.astype(jnp.int32)
    above = jnp.concatenate([p[:1], p[:-1]], axis=0)
    below = jnp.concatenate([p[1:], p[-1:]], axis=0)
    cs_even = 3 * p + above  # feeds output rows 2r
    cs_odd = 3 * p + below  # feeds output rows 2r+1
    out_even = _h2_fancy_cols(cs_even, bits=4, bias_even=8, bias_odd=7)
    out_odd = _h2_fancy_cols(cs_odd, bits=4, bias_even=8, bias_odd=7)
    h, w2 = out_even.shape
    out = jnp.stack([out_even, out_odd], axis=1).reshape(2 * h, w2)
    return out.astype(jnp.uint8)


def upsample_int(plane: jnp.ndarray, h_expand: int, v_expand: int) -> jnp.ndarray:
    """int_upsample: pixel replication for ratios without a fancy path."""
    out = jnp.repeat(plane, v_expand, axis=0)
    return jnp.repeat(out, h_expand, axis=1)


def upsample_h1v2_fancy(plane: jnp.ndarray) -> jnp.ndarray:
    """h1v2_fancy_upsample (libjpeg-turbo jdsample.c, the 4:4:0 case):
    [H, W] -> [2H, W]. Output row 2r blends input row r (x3) with r-1
    (bias 1); row 2r+1 blends r with r+1 (bias 2); edges replicate.
    Validated bit-exactly against PIL on synthetic 4:4:0 streams
    (tests/test_color.py)."""
    p = plane.astype(jnp.int32)
    up = jnp.concatenate([p[:1], p[:-1]], axis=0)     # row r-1, clamped
    down = jnp.concatenate([p[1:], p[-1:]], axis=0)   # row r+1, clamped
    even = (3 * p + up + 1) >> 2
    odd = (3 * p + down + 2) >> 2
    out = jnp.stack([even, odd], axis=1)  # [H, 2, W]
    return out.reshape(plane.shape[0] * 2, plane.shape[1]).astype(
        plane.dtype
    )


def upsample_component(
    plane: jnp.ndarray, h_expand: int, v_expand: int, fancy: bool = True
) -> jnp.ndarray:
    """Dispatch mirroring jdsample.c master selection (libjpeg-turbo:
    fullsize, h2v1 fancy, h1v2 fancy, h2v2 fancy, else integer
    replication)."""
    if h_expand == 1 and v_expand == 1:
        return plane
    if fancy and h_expand == 2 and v_expand == 1:
        return upsample_h2v1_fancy(plane)
    if fancy and h_expand == 1 and v_expand == 2:
        return upsample_h1v2_fancy(plane)
    if fancy and h_expand == 2 and v_expand == 2:
        return upsample_h2v2_fancy(plane)
    return upsample_int(plane, h_expand, v_expand)


# ---------------------------------------------------------------------------
# Color conversion (jdcolor.c semantics) — SURVEY.md §2.1 #16
# ---------------------------------------------------------------------------

SCALEBITS = 16
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def ycc_to_rgb(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray) -> jnp.ndarray:
    """JFIF YCbCr→RGB with libjpeg's 16-bit fixed-point tables:
      R = y + round(1.40200 * (cr-128))
      G = y - round(0.34414 * (cb-128) + 0.71414 * (cr-128))
      B = y + round(1.77200 * (cb-128))
    Returns uint8[..., 3]."""
    yi = y.astype(jnp.int32)
    cbi = cb.astype(jnp.int32) - 128
    cri = cr.astype(jnp.int32) - 128
    r = yi + ((_fix(1.40200) * cri + ONE_HALF) >> SCALEBITS)
    b = yi + ((_fix(1.77200) * cbi + ONE_HALF) >> SCALEBITS)
    g = yi + (
        ((-_fix(0.34414)) * cbi + (-_fix(0.71414)) * cri + ONE_HALF) >> SCALEBITS
    )
    rgb = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(rgb, 0, 255).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Whole-frame transform: coefficients → RGB/gray raster
# ---------------------------------------------------------------------------


def finish_color(planes: Sequence[jnp.ndarray], color: str) -> jnp.ndarray:
    """Final color interpretation of full-resolution sample planes,
    matching what PIL/libjpeg emits for each `bitstream.color_space`
    value (SURVEY.md §2.1 #16; jdcolor.c + PIL rawmode conventions):

      gray   -> [H, W]           the single plane
      ycbcr  -> [H, W, 3] RGB    jdcolor ycc_rgb fixed point
      rgb    -> [H, W, 3] RGB    passthrough (Adobe transform=0 / RGB ids)
      cmyk   -> [H, W, 4] CMYK   inverted planes (PIL rawmode 'CMYK;I')
      ycck   -> [H, W, 4] CMYK   ycc_rgb on ch0-2 + inverted K: libjpeg
               ycck_cmyk emits 255-R etc. and PIL's 'CMYK;I' inverts
               again, so the net per-channel value is exactly ycc_rgb's
               R/G/B (and 255-K)."""
    if color == "gray":
        return planes[0]
    if color == "ycbcr":
        return ycc_to_rgb(planes[0], planes[1], planes[2])
    if color == "rgb":
        return jnp.stack(planes, axis=-1)
    if color == "cmyk":
        inv = 255 - jnp.stack(planes, axis=-1).astype(jnp.int32)
        return inv.astype(jnp.uint8)
    if color == "ycck":
        rgb = ycc_to_rgb(planes[0], planes[1], planes[2])
        k = (255 - planes[3].astype(jnp.int32)).astype(jnp.uint8)
        return jnp.concatenate([rgb, k[..., None]], axis=-1)
    raise ValueError(f"unknown color space {color!r}")


def default_color(n_components: int) -> str:
    """Marker-blind color guess by component count (the pre-APP14
    behavior); callers with a parsed JpegData should prefer
    bitstream.color_space."""
    return {1: "gray", 3: "ycbcr", 4: "cmyk"}[n_components]


def transform_frame(
    frame: Frame,
    coeffs: Sequence[jnp.ndarray],
    qtabs_zz: Sequence[jnp.ndarray],
    fancy_upsampling: bool = True,
    color: Optional[str] = None,
    idct: str = "islow",
) -> jnp.ndarray:
    """coeffs[ci]: int32[padded_hb*padded_wb, 64] zigzag coefficients.
    qtabs_zz[ci]: int32[64] zigzag quantizer for that component. idct:
    'islow' (bit-exact) or 'matmul' (dequant_idct_matmul).
    Returns uint8[H, W, 3] (or [H, W] for grayscale, [H, W, 4] for
    CMYK/YCCK). Jit-safe: all shapes are static given the frame
    geometry."""
    if color is None:
        color = default_color(frame.n_components)
    planes: List[jnp.ndarray] = []
    for ci, c in enumerate(frame.components):
        cz, qz = jnp.asarray(coeffs[ci]), jnp.asarray(qtabs_zz[ci])
        if idct == "matmul":
            samples = dequant_idct_matmul(cz, qz)
        else:
            samples = idct8x8_islow(dequantize(cz, qz))
        plane = blocks_to_plane(samples, c.padded_hb, c.padded_wb)
        # Crop MCU padding BEFORE upsampling: libjpeg upsamples only
        # downsampled_width/height real samples, so edge replication in
        # the fancy filters must see the true edge (SURVEY.md §2.1 #17).
        plane = plane[: c.dheight, : c.dwidth]
        h_expand = frame.hmax // c.h
        v_expand = frame.vmax // c.v
        up = upsample_component(plane, h_expand, v_expand, fancy=fancy_upsampling)
        planes.append(up[: frame.height, : frame.width])

    return finish_color(planes, color)
