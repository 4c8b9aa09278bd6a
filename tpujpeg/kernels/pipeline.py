"""Batched whole-frame transform for the device chains: dequant + IDCT,
then upsample + color, as plain jnp that XLA fuses. Must produce
byte-identical output to transform.transform_frame — the fused decode
paths' tests assert it against PIL.

Everything is built batched ([N, ...] with one device dispatch per
bucket, SURVEY.md §3.5); the single-image path is the N=1 case.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

from .. import bitstream, transform as T
from ..config import DecodeConfig


def _make_frame(key: Tuple) -> bitstream.Frame:
    height, width, comps = key
    frame = bitstream.Frame(
        progressive=False,
        precision=8,
        height=height,
        width=width,
        components=[
            bitstream.Component(index=i, cid=i, h=h, v=v, tq=0)
            for i, (h, v) in enumerate(comps)
        ],
    )
    frame.finalize()
    return frame


def packed_layout_applies(frame, config: DecodeConfig, color: str) -> bool:
    """True iff _color_stage honors packed=True for this frame: YCbCr
    with h2v2 or h2v1 chroma, fancy upsampling and an even frame width.
    Callers use this STATIC predicate to know the output form."""
    if color != "ycbcr" or frame.n_components != 3:
        return False
    if not config.fancy_upsampling or frame.width % 2:
        return False
    expansions = [
        (frame.hmax // c.h, frame.vmax // c.v) for c in frame.components
    ]
    return expansions in (
        [(1, 1), (2, 2), (2, 2)], [(1, 1), (2, 1), (2, 1)]
    )


def pack16(rgb: jnp.ndarray) -> jnp.ndarray:
    """[N, H, W, 3] uint8 -> [N, 3, H, W//2] uint16 whose little-endian
    bytes are the planar u8 raster (the `packed16` layout)."""
    n, h, w, c = rgb.shape
    planar = rgb.transpose(0, 3, 1, 2).reshape(n, c, h, w // 2, 2)
    return jax.lax.bitcast_convert_type(planar, jnp.uint16)


def _color_stage(frame, expansions, planes, fancy: bool, color: str,
                 packed: bool = False):
    """Shared tail: cropped sample planes -> RGB/gray/CMYK raster
    (transform_frame's tail, vmapped over the batch). packed: return
    the pack16 layout instead of NHWC (the caller checked
    packed_layout_applies)."""
    if color == "gray":
        return planes[0][:, : frame.height, : frame.width]

    def tail(planes_one):
        ups = []
        for ci in range(frame.n_components):
            he, ve = expansions[ci]
            up = T.upsample_component(planes_one[ci], he, ve, fancy=fancy)
            ups.append(up[: frame.height, : frame.width])
        return T.finish_color(ups, color)

    rgb = jax.vmap(tail)(planes)
    return pack16(rgb) if packed else rgb


@functools.lru_cache(maxsize=128)
def _build_batch(key: Tuple, idct_variant: str, fancy: bool, color: str,
                 has_dc: bool = False, packed: bool = False,
                 per_image_q: bool = False):
    """Jitted [N, ...]-batched transform for one frame geometry. With
    has_dc, a separate per-block DC column rides in (the progressive
    decoder keeps DC out of the [blocks, 64] state — see
    wavefront_prog._scatter_dc_s) and merges here. With per_image_q,
    qtabs[ci] is [N, 64] (one quantizer per image). packed: see
    _color_stage."""
    frame = _make_frame(key)
    expansions = [
        (frame.hmax // c.h, frame.vmax // c.v) for c in frame.components
    ]

    def fn(coeffs: Sequence[jnp.ndarray], qtabs: Sequence[jnp.ndarray],
           dcs=None):
        n = coeffs[0].shape[0]
        planes: List[jnp.ndarray] = []
        for ci, c in enumerate(frame.components):
            nb = c.padded_hb * c.padded_wb
            blk = coeffs[ci].reshape(n, nb, 64)
            if has_dc:
                blk = blk.at[:, :, 0].set(dcs[ci].reshape(n, nb))
            q = qtabs[ci]
            if per_image_q:
                blk = blk * q[:, None, :]
                q = 1
            flat = blk.reshape(n * nb, 64)
            if idct_variant == "matmul":
                samples = T.dequant_idct_matmul(flat, q)
            else:
                samples = T.idct8x8_islow(T.dequantize(flat, q))
            plane = T.blocks_to_plane(
                samples, n * c.padded_hb, c.padded_wb
            ).reshape(n, c.padded_hb * 8, c.padded_wb * 8)
            planes.append(plane[:, : c.dheight, : c.dwidth])
        return _color_stage(frame, expansions, planes, fancy, color, packed)

    return jax.jit(fn)


@functools.lru_cache(maxsize=128)
def _build_planes_batch(key: Tuple, fancy: bool, color: str,
                        packed: bool = False):
    """Jitted color/upsample stage for pre-IDCT'd sample planes
    ([N, padded_h, padded_w] uint8 per component — the fused wavefront
    kernel's output layout)."""
    frame = _make_frame(key)
    expansions = [
        (frame.hmax // c.h, frame.vmax // c.v) for c in frame.components
    ]

    def fn(planes_in: Sequence[jnp.ndarray]):
        planes = [
            p[:, : c.dheight, : c.dwidth]
            for p, c in zip(planes_in, frame.components)
        ]
        return _color_stage(frame, expansions, planes, fancy, color, packed)

    return jax.jit(fn)


def _frame_key(frame) -> Tuple:
    return (
        frame.height,
        frame.width,
        tuple((c.h, c.v) for c in frame.components),
    )


def transform_planes_batch(frame, planes, config: DecodeConfig,
                           color: str = None, packed: bool = False):
    """planes[ci]: uint8[N, padded_h, padded_w] sample planes.
    packed: see _color_stage — the caller checked
    packed_layout_applies."""
    if color is None:
        color = T.default_color(frame.n_components)
    fn = _build_planes_batch(
        _frame_key(frame), config.fancy_upsampling, color, packed
    )
    return fn([jnp.asarray(p) for p in planes])


def transform_batch(
    frame: bitstream.Frame,
    coeffs: Sequence,
    qtabs: Sequence,
    config: DecodeConfig,
    color: str = None,
    dcs: Sequence = None,
    packed: bool = False,
):
    """coeffs[ci]: int32[N, padded_blocks, 64] zigzag; qtabs[ci]:
    int32[64], or int32[N, 64] for per-image quantizers; dcs[ci]
    (optional): int32[N, padded_blocks] DC columns to merge into
    coefficient slot 0 (see _build_batch). Returns uint8[N, H, W, 3]
    (or [N, H, W] grayscale, [N, H, W, 4] CMYK); with packed (and
    packed_layout_applies) the pack16 form."""
    if color is None:
        color = T.default_color(frame.n_components)
    fn = _build_batch(
        _frame_key(frame), config.idct, config.fancy_upsampling, color,
        has_dc=dcs is not None,
        packed=packed and packed_layout_applies(frame, config, color),
        per_image_q=getattr(qtabs[0], "ndim", 1) == 2,
    )
    args = (
        [jnp.asarray(c) for c in coeffs], [jnp.asarray(q) for q in qtabs]
    )
    if dcs is None:
        return fn(*args)
    return fn(*args, [jnp.asarray(d) for d in dcs])
