"""Decode orchestration (SURVEY.md §1 L4): parse → entropy → transform.

Mirrors the reference's decoder core / scan controller (SURVEY.md §3.1
call stack). On the GPU a supported baseline stream takes the fused
single-dispatch chain (wavefront entropy + IDCT + upsample/color in one
program); otherwise the staged path runs: the host produces coefficient
tensors (via the Python oracle, the native C decoder, or the wavefront
kernel), then a single jitted jnp transform reconstructs the raster on
the device.
"""

from __future__ import annotations

import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import bitstream, huffman, transform
from .backend import pallas_interpret
from .config import DEFAULT_CONFIG, DecodeConfig
from .errors import JpegError, JpegUnsupportedError
from .stats import DecodeStats


def _geometry_key(
    frame: bitstream.Frame, fancy: bool, idct: str, color: str
) -> Tuple:
    comps = tuple(
        (c.h, c.v, c.padded_hb, c.padded_wb, c.dheight, c.dwidth)
        for c in frame.components
    )
    return (frame.height, frame.width, comps, fancy, idct, color)


@functools.lru_cache(maxsize=256)
def _jit_transform(key: Tuple, frame_repr: str):
    """Build and cache a jitted transform for one frame geometry. The
    frame object itself can't be a cache key (unhashable/mutable), so the
    caller passes the geometry tuple; we reconstruct a static Frame from
    it."""
    height, width, comps, fancy, idct, color = key
    frame = bitstream.Frame(
        progressive=False,
        precision=8,
        height=height,
        width=width,
        components=[
            bitstream.Component(
                index=i, cid=i, h=h, v=v, tq=0,
            )
            for i, (h, v, phb, pwb, dh, dw) in enumerate(comps)
        ],
    )
    frame.finalize()
    # finalize() recomputes geometry from H/W/h/v; assert it round-trips.
    for c, (h, v, phb, pwb, dh, dw) in zip(frame.components, comps):
        assert (c.padded_hb, c.padded_wb, c.dheight, c.dwidth) == (phb, pwb, dh, dw)

    def fn(coeffs, qtabs):
        return transform.transform_frame(
            frame, coeffs, qtabs, fancy_upsampling=fancy, color=color,
            idct=idct,
        )

    return jax.jit(fn)


def _entropy_decode(
    jpeg: bitstream.JpegData, config: DecodeConfig, stats: DecodeStats
) -> List[np.ndarray]:
    """Run the entropy stage with the best available engine."""
    engine = config.entropy_engine
    if engine == "auto":
        try:
            from .native import build as native_build

            native_build.get_lib()
            engine = "native"
        except Exception:
            engine = "python"

    if engine == "native":
        from .native import entropy as native_entropy

        stats.entropy_engine = "native"
        return native_entropy.decode_all_scans(jpeg)
    if engine == "wavefront":
        stats.entropy_engine = "wavefront"
        try:
            # Block-synchronous Pallas kernel when the stream fits its
            # scope; XLA wavefront otherwise. Only capability errors
            # fall back — a genuine data error (bad Huffman code,
            # truncation) must surface, not be re-decoded by an engine
            # with a different error taxonomy.
            from .kernels import wavefront_pallas

            return wavefront_pallas.decode_all_scans(jpeg, config)
        except JpegUnsupportedError:
            stats.entropy_fallbacks += 1
            from .kernels import wavefront

            return wavefront.decode_all_scans(jpeg, config)
    stats.entropy_engine = "python"
    return huffman.decode_all_scans(jpeg)


def _decode_fused_single(
    jpeg: bitstream.JpegData, config: DecodeConfig, stats: DecodeStats
):
    """Batch-1 fused one-dispatch decode, or None when the stream is
    outside the fused paths' scope (the staged pipeline handles it).
    Data errors (bad code, truncation) raise — they are the stream's
    fault, not a capability limit."""
    from .kernels import wavefront_pallas

    t0 = time.perf_counter()
    try:
        rgb, failures = wavefront_pallas.decode_batch_to_rgb([jpeg], config)
        if 0 in failures:
            raise failures[0]
        out = rgb[0]
        stats.entropy_engine = "wavefront-fused"
    except JpegUnsupportedError:
        try:
            out = wavefront_pallas.decode_norst_to_rgb(jpeg, config)
            stats.entropy_engine = "wavefront-fused-norst"
        except JpegUnsupportedError:
            return None
    out = jax.block_until_ready(out)
    stats.t_entropy = 0.0
    stats.t_transform = time.perf_counter() - t0
    stats.transform_engine = "fused"
    return out


def decode(
    data: bytes,
    config: DecodeConfig = DEFAULT_CONFIG,
    return_stats: bool = False,
):
    """Decode one JPEG byte string to a uint8 array ([H,W,3] RGB or
    [H,W] grayscale). Library entry point (SURVEY.md §1 L5 successor)."""
    stats = DecodeStats()

    t0 = time.perf_counter()
    jpeg = bitstream.parse(data)
    stats.t_parse = time.perf_counter() - t0
    frame = jpeg.frame
    stats.width, stats.height = frame.width, frame.height
    stats.n_components = frame.n_components
    stats.progressive = frame.progressive
    stats.n_scans = len(jpeg.scans)
    stats.n_segments = sum(len(s.rst_offsets) + 1 for s in jpeg.scans)
    stats.restart_interval = jpeg.restart_interval
    stats.bitstream_bytes = len(data)
    stats.total_blocks = sum(c.padded_hb * c.padded_wb for c in frame.components)

    # Single-dispatch fast path (SURVEY.md §3.1): where the kernels
    # compile (the GPU), a supported baseline stream runs the batch-1
    # fully fused chain — wavefront entropy + dequant + IDCT +
    # upsample/color as ONE XLA program, one dispatch, one readback —
    # instead of a device round-trip per stage. Marker-free/oversize-DRI
    # streams take the skeleton-split fused chain. Falls through to the
    # staged path on any capability limit; entropy-engine overrides
    # disable it. In interpret mode (CPU) the staged path is faster.
    if (
        not frame.progressive
        and not pallas_interpret()
        and config.entropy_engine in ("auto", "wavefront")
    ):
        out = _decode_fused_single(jpeg, config, stats)
        if out is not None:
            if config.to_numpy:
                out = np.asarray(out)
            if return_stats:
                return out, stats
            return out

    t0 = time.perf_counter()
    coeffs = _entropy_decode(jpeg, config, stats)
    stats.t_entropy = time.perf_counter() - t0

    t0 = time.perf_counter()
    qtabs = [jpeg.qtables[c.tq] for c in frame.components]
    color = bitstream.color_space(jpeg)

    stats.transform_engine = "jnp"
    key = _geometry_key(frame, config.fancy_upsampling, config.idct, color)
    fn = _jit_transform(key, repr(key))
    out = fn(
        [jnp.asarray(c) for c in coeffs], [jnp.asarray(q) for q in qtabs]
    )
    out = jax.block_until_ready(out)
    stats.t_transform = time.perf_counter() - t0

    if config.to_numpy:
        out = np.asarray(out)
    if return_stats:
        return out, stats
    return out


def decode_file(path: str, config: DecodeConfig = DEFAULT_CONFIG, **kw):
    with open(path, "rb") as f:
        return decode(f.read(), config, **kw)
