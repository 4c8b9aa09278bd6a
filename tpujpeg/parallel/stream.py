"""Double-buffered host-prep <-> device-decode pipeline (SURVEY.md §2.3
PP row "host parse/scan stage overlapped with device decode of previous
batch (double-buffered infeed)"; §3.5 batched call stack).

The stages per chunk of images:

  prep   (worker threads)  parse markers + destuff segments + build the
                           wavefront block plan — pure host CPU work
  submit (main thread)     upload the plan arrays and dispatch the fused
                           wavefront+IDCT+upsample+color chain; JAX
                           dispatch is asynchronous, so this returns as
                           soon as the program is enqueued
  sync   (main thread)     read back the tiny per-lane error vector,
                           which waits for the whole program

With a device window of `depth` chunks and `prep_workers` threads, the
chip decodes chunk N while the host preps chunks N+1..N+k and the main
thread syncs chunk N-1: steady-state wall clock per chunk is
max(device time, prep time / workers) instead of their sum. Chunks the
fused kernel can't take (mixed geometry, progressive, oversize
segments) go through `decode_batch_on_device` at sync time — slower,
but the stream never stalls on a bad file. Only stream errors
(JpegError) are isolated; a device fault raises.
"""

from __future__ import annotations

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from .. import bitstream
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..errors import JpegError, JpegUnsupportedError
from ..stats import DecodeStats
from .batch import BatchResult, decode_batch_on_device


@dataclasses.dataclass
class _Unit:
    """One prepped chunk: either a fused-kernel plan or a fallback."""

    members: List[int]  # original indices of cleanly parsed images
    jpegs: List[bitstream.JpegData]
    plan: Optional[object]  # wavefront_pallas.BlockPlan, None -> fallback
    failures: Dict[int, Exception]  # original index -> parse error
    datas: Optional[List[bytes]] = None  # kept only for the fallback path


@dataclasses.dataclass
class StreamChunk:
    """One decoded chunk, yielded in submission order. `images[k]` is the
    decoded array for original index `members[k]` (a lazy slice of the
    chunk's device-resident batch on the fused path), or None when
    `failures` has that index. `layout` is "nhwc" (uint8 [H, W, 3]) or
    "packed16" (planar uint16 [3, H, W//2] whose little-endian bytes
    are the planar u8 raster — bitcast on the consumer side is free)."""

    members: List[int]
    images: List[Optional[object]]
    failures: Dict[int, Exception]
    engine: str
    layout: str = "nhwc"


def _prep(datas: Sequence[bytes], members: List[int]) -> _Unit:
    """Worker-thread stage: parse + plan build, fault-isolated."""
    from ..kernels import wavefront_pallas as wp

    jpegs: List[bitstream.JpegData] = []
    ok: List[int] = []
    failures: Dict[int, Exception] = {}
    for i in members:
        try:
            j = bitstream.parse(datas[i])
            jpegs.append(j)
            ok.append(i)
        except JpegError as e:
            failures[i] = e
    if not ok:
        return _Unit(ok, jpegs, None, failures)
    try:
        if any(j.frame.progressive for j in jpegs):
            raise JpegUnsupportedError("progressive: host entropy path")
        plan = wp.build_block_plan(jpegs)
        if not plan.qsets:
            raise JpegUnsupportedError("too many quantizer sets: no fused path")
    except JpegUnsupportedError:
        return _Unit(ok, jpegs, None, failures, [datas[i] for i in ok])
    except JpegError as e:
        # A data error detected at plan time (e.g. missing segments)
        # poisons the whole chunk only if we can't tell images apart;
        # fall back so per-image isolation handles it.
        return _Unit(ok, jpegs, None, failures, [datas[i] for i in ok])
    return _Unit(ok, jpegs, plan, failures)


class _InFlight:
    __slots__ = ("unit", "rgb", "err", "layout")

    def __init__(self, unit, rgb=None, err=None, layout="nhwc"):
        self.unit = unit
        self.rgb = rgb
        self.err = err
        self.layout = layout


def _submit(unit: _Unit, config: DecodeConfig,
            packed: bool = False) -> _InFlight:
    """Main-thread stage: upload + async dispatch of the fused chain."""
    from ..kernels import pipeline as kernel_pipeline
    from ..kernels import wavefront_pallas as wp

    if unit.plan is None:
        return _InFlight(unit)  # fallback decodes at sync time
    layout = "nhwc"
    if packed:
        frame = unit.jpegs[0].frame
        color = bitstream.color_space(unit.jpegs[0])
        if kernel_pipeline.packed_layout_applies(frame, config, color):
            layout = "packed16"
    fn = wp._rgb_chain(
        unit.plan, unit.jpegs, config, packed=layout == "packed16"
    )
    rgb, err = fn(
        jnp.asarray(unit.plan.bits),
        jnp.asarray(unit.plan.lane_m),
        jnp.asarray(unit.plan.seg_bits),
        jnp.asarray(unit.plan.lane_qset),
    )
    return _InFlight(unit, rgb, err, layout)


def _sync(flight: _InFlight, config: DecodeConfig) -> StreamChunk:
    """Main-thread stage: force completion, map failures, slice images."""
    from ..kernels import wavefront_pallas as wp

    unit = flight.unit
    failures = dict(unit.failures)

    if unit.plan is None:
        images: List[Optional[object]] = [None] * len(unit.members)
        if unit.datas:
            # Device ladder: progressive scan kernels, coeff mode,
            # per-image DC-primed fused decode (marker-free / oversize
            # segments / per-image tables) — everything the shared
            # fused plan rejected.
            res = decode_batch_on_device(unit.datas, config)
            for k, i in enumerate(unit.members):
                if k in res.errors:
                    failures[i] = res.errors[k]
                else:
                    images[k] = res.images[k]
        members = list(unit.members) + list(unit.failures)
        images += [None] * len(unit.failures)
        return StreamChunk(members, images, failures, "fallback")

    errs = np.asarray(flight.err).reshape(-1)[: unit.plan.n_lanes]  # sync
    local = wp.failures_from_err(errs, unit.plan.lane_meta)
    images = []
    for k, i in enumerate(unit.members):
        if k in local:
            failures[i] = local[k]
            images.append(None)
        else:
            images.append(flight.rgb[k])
    members = list(unit.members) + list(unit.failures)
    images += [None] * len(unit.failures)
    return StreamChunk(
        members, images, failures, "wavefront-fused", flight.layout
    )


def decode_stream(
    datas: Sequence[bytes],
    config: DecodeConfig = DEFAULT_CONFIG,
    chunk_size: int = 64,
    depth: int = 2,
    prep_workers: int = 3,
    layout: str = "nhwc",
) -> Iterator[StreamChunk]:
    """Decode a long sequence of JPEGs as a pipelined stream of chunks.

    Yields one StreamChunk per `chunk_size` images, in order. Host prep
    of later chunks runs on `prep_workers` threads while the device
    decodes, with at most `depth` chunks in flight on the device — the
    real double-buffered infeed the PP row of SURVEY.md §2.3 names.
    Images are device-resident unless config.to_numpy (conversion forces
    an immediate readback, serializing the pipeline — leave outputs on
    device when throughput matters).

    layout="packed16" requests the planar uint16 form (chunk.layout says
    whether it applied; pipeline.pack16): its little-endian bytes are
    the planar u8 raster, so consumers bitcast for free."""
    n = len(datas)
    starts = list(range(0, n, chunk_size))
    with ThreadPoolExecutor(max_workers=prep_workers) as ex:
        prep_q: collections.deque = collections.deque()
        inflight: collections.deque = collections.deque()
        next_chunk = 0

        def refill():
            nonlocal next_chunk
            while (
                next_chunk < len(starts)
                and len(prep_q) < prep_workers + depth
            ):
                s = starts[next_chunk]
                members = list(range(s, min(s + chunk_size, n)))
                prep_q.append(ex.submit(_prep, datas, members))
                next_chunk += 1

        refill()
        while prep_q or inflight:
            while prep_q and len(inflight) < depth:
                unit = prep_q.popleft().result()
                refill()
                inflight.append(
                    _submit(unit, config, packed=layout == "packed16")
                )
            chunk = _sync(inflight.popleft(), config)
            if config.to_numpy:
                chunk.images = [
                    None if im is None else np.asarray(im)
                    for im in chunk.images
                ]
            yield chunk


def decode_batch_pipelined(
    datas: Sequence[bytes],
    config: DecodeConfig = DEFAULT_CONFIG,
    chunk_size: int = 64,
    depth: int = 2,
    prep_workers: int = 3,
) -> BatchResult:
    """decode_batch_on_device semantics through the overlapped pipeline:
    same BatchResult, built by draining decode_stream."""
    n = len(datas)
    images: List[Optional[object]] = [None] * n
    errors: Dict[int, Exception] = {}
    stats: List[Optional[DecodeStats]] = [None] * n
    for chunk in decode_stream(
        datas, config, chunk_size=chunk_size, depth=depth,
        prep_workers=prep_workers,
    ):
        errors.update(chunk.failures)
        for k, i in enumerate(chunk.members):
            if i in chunk.failures:
                continue
            images[i] = chunk.images[k]
            st = DecodeStats()
            st.entropy_engine = chunk.engine
            st.transform_engine = "fused"
            stats[i] = st
    return BatchResult(images=images, errors=errors, stats=stats)
