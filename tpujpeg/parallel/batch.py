"""Batched decode (BASELINE.json:9 config 3): many mixed-size JPEGs,
bucketed by frame geometry, transformed as one data-parallel device pass
per bucket (SURVEY.md §3.5 call stack).

Fault isolation (SURVEY.md §5): a corrupt image (any JpegError) marks
its slot failed and never kills the batch; anything else — a device
compile or runtime fault — raises.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import bitstream, transform
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..decoder import _entropy_decode
from ..errors import JpegError
from ..stats import DecodeStats
from . import mesh as mesh_lib


@dataclasses.dataclass
class BatchResult:
    """Per-image outputs; `errors[i]` is set iff `images[i]` is None."""

    images: List[Optional[np.ndarray]]
    errors: Dict[int, Exception]
    stats: List[Optional[DecodeStats]]


def _bucket_key(jpeg: bitstream.JpegData) -> Tuple:
    frame = jpeg.frame
    return (
        frame.height,
        frame.width,
        tuple((c.h, c.v) for c in frame.components),
        # Color interpretation is marker-driven (JFIF/Adobe APP14), so a
        # YCbCr and an Adobe-RGB file with identical geometry must not
        # share a jitted transform.
        bitstream.color_space(jpeg),
    )


def decode_batch_on_device(
    datas: Sequence[bytes],
    config: DecodeConfig = DEFAULT_CONFIG,
) -> "BatchResult":
    """Full on-device decode (SURVEY.md §3.5 + north star
    BASELINE.json:5): bitstreams ship to device memory once, the
    wavefront kernel entropy-decodes every image's restart segments in
    ONE launch per geometry bucket with dequant + IDCT fused in, and the
    same program finishes upsample/color — coefficients never touch the
    host. `images` holds device arrays (jax.Array), converted only if
    config.to_numpy. Only stream errors (JpegError) are isolated per
    image; anything else — a device compile or runtime fault — raises."""
    from ..kernels import pipeline as kernel_pipeline
    from ..kernels import wavefront

    n = len(datas)
    images: List[Optional[np.ndarray]] = [None] * n
    errors: Dict[int, Exception] = {}
    stats: List[Optional[DecodeStats]] = [None] * n

    # Host stage: parse only (metadata-sized), fault-isolated.
    jpegs: List[Optional[bitstream.JpegData]] = [None] * n
    valid: List[int] = []
    progressive: List[int] = []
    for i, data in enumerate(datas):
        try:
            j = bitstream.parse(data)
            jpegs[i] = j
            (progressive if j.frame.progressive else valid).append(i)
        except JpegError as e:
            errors[i] = e

    # Progressive images: device scan kernels, cross-image batched.
    # Images sharing a scan_group_key (same geometry + scan script +
    # tables — the common case for one encoder's corpus) decode with
    # ONE kernel launch per scan index; singleton groups take the same
    # path with one image's lanes.
    if progressive:
        from ..kernels import pipeline as kp
        from ..kernels import wavefront_prog

        groups: Dict[Tuple, List[int]] = {}
        for i in progressive:
            j = jpegs[i]
            # Quantizers are NOT part of the key: the one-jit chain
            # dequantizes per image in XLA (per_image_q), so a
            # mixed-quality corpus (q85 + q70 of one encoder) shares a
            # single launch. Huffman tables (in scan_group_key) are the
            # real constraint — one table operand serves every lane of
            # a scan kernel.
            key = (
                wavefront_prog.scan_group_key(j),
                bitstream.color_space(j),
            )
            groups.setdefault(key, []).append(i)

        def _prog_one(i: int) -> None:
            from ..errors import JpegUnsupportedError

            j = jpegs[i]
            try:
                rgb, _layout, failures = (
                    wavefront_prog.decode_all_scans_to_rgb_batch(
                        [j], config
                    )
                )
                if 0 in failures:
                    errors[i] = failures[0]
                else:
                    _prog_emit(i, None, out=rgb[0])
                return
            except JpegUnsupportedError:
                pass  # host entropy below — valid files never fail here
            except JpegError as e:
                errors[i] = e
                return
            try:
                # Outside the device scan kernels' scope (a progressive
                # scan with no restart segmentation and a payload over
                # MAX_WORDS): host entropy, device transform — on
                # purpose, not as a fault fallback.
                st0 = DecodeStats()
                coeffs = _entropy_decode(j, config, st0)
                _prog_emit(i, coeffs, engine=st0.entropy_engine)
            except JpegError as e:
                errors[i] = e

        def _prog_emit(i: int, state, out=None,
                       engine: str = "wavefront-prog", dc=None) -> None:
            j = jpegs[i]
            frame = j.frame
            if out is None:
                qtabs = [
                    jnp.asarray(j.qtables[c.tq]) for c in frame.components
                ]
                out = kp.transform_batch(
                    frame, [s[None] for s in state], qtabs, config,
                    color=bitstream.color_space(j),
                    dcs=None if dc is None else [d[None] for d in dc],
                )[0]
            images[i] = np.asarray(out) if config.to_numpy else out
            st = DecodeStats()
            st.width, st.height = frame.width, frame.height
            st.n_components = frame.n_components
            st.progressive = True
            st.entropy_engine = engine
            st.transform_engine = "fused" if state is None else "jnp"
            stats[i] = st

        # Two phases: DISPATCH every group's one-jit chain (no
        # readbacks — the async dispatches overlap on device, which
        # matters because distinct progressive files rarely share
        # Huffman tables and so decode as singleton groups), then
        # RESOLVE each group's deferred error vectors in order.
        pending = []
        for key, members in groups.items():
            try:
                sub = [jpegs[i] for i in members]
                # ONE jitted program per group: scan kernels + transform
                # (mixed quantizers fine — per-image dequant in XLA).
                # Tables are runtime operands, so one compile per
                # scan-script shape serves every table set.
                rgb, _layout, deferred = (
                    wavefront_prog.decode_all_scans_to_rgb_batch(
                        sub, config, defer_errors=True
                    )
                )
                pending.append((members, rgb, deferred))
            except JpegError:
                # A plan-time error (truncated segments, oversize scan)
                # poisons the shared plan: re-decode per image so one
                # bad file can't take down its group.
                for i in members:
                    _prog_one(i)
        # Pop as we resolve so each group's device RGB is released
        # before the next group materializes on host — peak HBM stays
        # one group's output, not the whole batch's.
        while pending:
            members, rgb, (errs_d, plans_d) = pending.pop(0)
            failures = wavefront_prog.resolve_scan_errors(errs_d, plans_d)
            for li, exc in failures.items():
                errors[members[li]] = exc
            for li in range(len(members)):
                if li not in failures:
                    _prog_emit(members[li], None, out=rgb[li])

    if not valid:
        return BatchResult(images=images, errors=errors, stats=stats)

    # Bucket by geometry + color space only: the fused kernel takes
    # mixed quantizers (per-lane one-hot dequant, up to MAX_QSETS sets)
    # and mixed restart intervals, so a q85/q86 pair shares ONE launch —
    # wavefront entropy + dequant + IDCT in one kernel, upsample/color
    # in the same program; coefficients never exist in device memory. Buckets the fused
    # path can't take (mixed Huffman tables, oversize segments, no
    # restart markers) fall back to the device coefficient decode, then
    # the XLA wavefront.
    buckets: Dict[Tuple, List[int]] = {}
    for i in valid:
        buckets.setdefault(_bucket_key(jpegs[i]), []).append(i)

    from ..kernels import wavefront_pallas

    def record(i, img, engine, frame, ncomp, transform_engine="fused"):
        images[i] = np.asarray(img) if config.to_numpy else img
        st = DecodeStats()
        st.width, st.height = frame.width, frame.height
        st.n_components = ncomp
        st.entropy_engine = engine
        st.entropy_fallbacks = 0 if engine == "wavefront-fused" else 1
        st.transform_engine = transform_engine
        stats[i] = st

    # Two phases over the buckets: DISPATCH every bucket's fused chain
    # without reading anything back (async dispatches overlap on
    # device — per-bucket error syncs serialized mixed-geometry batches
    # on the dispatch round-trip), then RESOLVE the deferred error
    # vectors; buckets the fused path rejects queue for the slow path.
    pending_rgb = []
    slow = []
    for _key, members in buckets.items():
        sub = [jpegs[i] for i in members]
        frame = sub[0].frame
        ncomp = frame.n_components
        try:
            rgb, deferred = wavefront_pallas.decode_batch_to_rgb(
                sub, config, defer_errors=True
            )
            pending_rgb.append((members, sub, frame, ncomp, rgb, deferred))
        except JpegError:
            slow.append((members, sub, frame, ncomp))

    # Pop as we resolve (same HBM-release rationale as the progressive
    # pending loop above).
    while pending_rgb:
        members, sub, frame, ncomp, rgb, (err_d, plan_d) = pending_rgb.pop(0)
        failures = wavefront_pallas.resolve_rgb_errors(err_d, plan_d)
        for local_i, i in enumerate(members):
            if local_i in failures:
                errors[i] = failures[local_i]
            else:
                record(i, rgb[local_i], "wavefront-fused", frame, ncomp)

    for members, sub, frame, ncomp in slow:
        # Coefficient fallback for this bucket.
        try:
            coeffs_dev, failures = wavefront_pallas.decode_batch_to_device(
                sub, config, strict=False
            )
            engine = "wavefront-pallas-coeff"
        except JpegError:
            from ..errors import JpegUnsupportedError

            # Per-image skeleton split: marker-free streams, oversize
            # restart segments and per-image Huffman tables still run
            # the FULLY FUSED chain (DC-primed skeleton lanes,
            # decode_norst_to_rgb) before the slow XLA single-lane
            # fallback.
            try:
                fused_failed: Dict[int, Exception] = {}
                fused_imgs: Dict[int, object] = {}
                for li, j in enumerate(sub):
                    try:
                        fused_imgs[li] = wavefront_pallas.decode_norst_to_rgb(
                            j, config
                        )
                    except JpegUnsupportedError:
                        raise
                    except JpegError as e:
                        fused_failed[li] = e
                for li, exc in fused_failed.items():
                    errors[members[li]] = exc
                for li, img in fused_imgs.items():
                    record(members[li], img, "wavefront-skeleton", frame,
                           ncomp)
                continue
            except JpegUnsupportedError:
                coeffs_dev, failures = wavefront.decode_batch_to_device(
                    sub, config, strict=False
                )
                engine = "wavefront-xla"
        for local_i, exc in failures.items():
            errors[members[local_i]] = exc
        ok = [li for li in range(len(members)) if li not in failures]
        if not ok:
            continue
        # transform_batch takes one quantizer per component, so the
        # coefficient fallback sub-buckets by quantizer identity.
        by_q: Dict[Tuple, List[int]] = {}
        for li in ok:
            qkey = tuple(
                sub[li].qtables[c.tq].astype(np.int32).tobytes()
                for c in frame.components
            )
            by_q.setdefault(qkey, []).append(li)
        for q_members in by_q.values():
            coeff_stack = [
                jnp.stack([coeffs_dev[li][ci] for li in q_members])
                for ci in range(ncomp)
            ]
            qtabs = [
                jnp.asarray(sub[q_members[0]].qtables[c.tq])
                for c in frame.components
            ]
            out = kernel_pipeline.transform_batch(
                frame, coeff_stack, qtabs, config,
                color=bitstream.color_space(sub[q_members[0]]),
            )
            for slot, li in enumerate(q_members):
                record(members[li], out[slot], engine, frame, ncomp, "jnp")

    return BatchResult(images=images, errors=errors, stats=stats)


@functools.lru_cache(maxsize=64)
def _jit_batched_transform(key: Tuple, n_devices: int, axis: str):
    """One jitted, device-sharded, vmapped transform per geometry bucket."""
    height, width, hv, color, fancy, idct = key
    frame = bitstream.Frame(
        progressive=False,
        precision=8,
        height=height,
        width=width,
        components=[
            bitstream.Component(index=i, cid=i, h=h, v=v, tq=0)
            for i, (h, v) in enumerate(hv)
        ],
    )
    frame.finalize()

    def one(coeffs, qtabs):
        return transform.transform_frame(
            frame, coeffs, qtabs, fancy_upsampling=fancy, color=color,
            idct=idct,
        )

    batched = jax.vmap(one)
    if n_devices <= 1:
        return jax.jit(batched), None
    m = mesh_lib.data_mesh(axis=axis)
    shard = NamedSharding(m, P(axis))
    fn = jax.jit(batched, in_shardings=(shard, shard), out_shardings=shard)
    return fn, m


def decode_batch(
    datas: Sequence[bytes],
    config: DecodeConfig = DEFAULT_CONFIG,
    n_devices: Optional[int] = None,
) -> BatchResult:
    """Decode a batch of JPEG byte strings. Images are bucketed by
    (H, W, sampling) so each bucket is one padded device launch sharded
    over the 'data' mesh axis (SURVEY.md §2.3 DP row)."""
    if n_devices is None:
        n_devices = jax.device_count()

    n = len(datas)
    images: List[Optional[np.ndarray]] = [None] * n
    errors: Dict[int, Exception] = {}
    stats: List[Optional[DecodeStats]] = [None] * n

    # Host stage: parse + entropy decode, fault-isolated per image.
    buckets: Dict[Tuple, List[Tuple[int, list, list]]] = {}
    for i, data in enumerate(datas):
        st = DecodeStats()
        try:
            jpeg = bitstream.parse(data)
            coeffs = _entropy_decode(jpeg, config, st)
            qtabs = [jpeg.qtables[c.tq] for c in jpeg.frame.components]
        except JpegError as e:
            errors[i] = e
            continue
        st.width, st.height = jpeg.frame.width, jpeg.frame.height
        st.n_components = jpeg.frame.n_components
        stats[i] = st
        buckets.setdefault(_bucket_key(jpeg), []).append((i, coeffs, qtabs))

    # Device stage: one launch per bucket.
    for key, entries in buckets.items():
        b = len(entries)
        ncomp = len(entries[0][1])
        fn, _ = _jit_batched_transform(
            key + (config.fancy_upsampling, config.idct), n_devices,
            config.mesh_axis,
        )
        pad = (-b) % max(n_devices, 1)
        coeff_stack = []
        qtab_stack = []
        for ci in range(ncomp):
            arrs = [e[1][ci] for e in entries]
            arrs += [np.zeros_like(arrs[0])] * pad
            coeff_stack.append(jnp.asarray(np.stack(arrs)))
            qs = [e[2][ci] for e in entries]
            qs += [np.zeros_like(qs[0])] * pad
            qtab_stack.append(jnp.asarray(np.stack(qs)))
        out = np.asarray(jax.block_until_ready(fn(coeff_stack, qtab_stack)))
        for slot, (i, _, _) in enumerate(entries):
            images[i] = out[slot]

    return BatchResult(images=images, errors=errors, stats=stats)
