"""MCU-row sharded single-image decode with halo exchange between devices
(BASELINE.json:11 config 5; SURVEY.md §2.3 SP/CP row, §3.4).

One giant image's MCU rows are sharded across devices on a 'rows' mesh
axis. Each device runs dequant+IDCT+assembly on its own MCU rows; the
h2v2 chroma upsampler needs one sample row of vertical context at each
shard boundary, exchanged with jax.lax.ppermute between devices — the decoder's
ring/halo pattern (SURVEY.md §2.3 "ring attention" analogue). Color
conversion is pointwise and needs no exchange.

Also provides the cross-shard DC-predictor prefix fixup
(BASELINE.json:5 "DC-predictor state via collectives") used when an
entropy stream is split at non-restart boundaries: each shard's DC
deltas are only locally summed, and the true predictors are recovered by
an exclusive prefix-sum of per-shard totals over the mesh axis.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from .. import bitstream, transform
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..errors import JpegUnsupportedError


def _h2v2_fancy_with_halo(
    plane: jnp.ndarray, above: jnp.ndarray, below: jnp.ndarray
) -> jnp.ndarray:
    """upsample_h2v2_fancy where the vertical neighbors of the first/last
    rows come from explicit halo rows instead of edge replication.
    plane: int[H, W]; above/below: int[1, W]."""
    p = plane.astype(jnp.int32)
    up = jnp.concatenate([above.astype(jnp.int32), p[:-1]], axis=0)
    dn = jnp.concatenate([p[1:], below.astype(jnp.int32)], axis=0)
    cs_even = 3 * p + up
    cs_odd = 3 * p + dn
    out_even = transform._h2_fancy_cols(cs_even, bits=4, bias_even=8, bias_odd=7)
    out_odd = transform._h2_fancy_cols(cs_odd, bits=4, bias_even=8, bias_odd=7)
    h, w2 = out_even.shape
    return jnp.stack([out_even, out_odd], axis=1).reshape(2 * h, w2).astype(jnp.uint8)


def _exchange_halo(
    plane: jnp.ndarray, axis: str, bottom_edge_shard: Optional[int] = None
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Return (above, below) single-row halos for this shard via ppermute;
    global edge shards fall back to their own edge row (replication),
    matching the fancy upsampler's edge behavior.

    `bottom_edge_shard` marks the last shard holding REAL image rows when
    trailing shards are pure MCU-row padding (decode_sharded pads so the
    shard count divides mcus_y): that shard's bottom row is already the
    replicated true edge (the in-shard padding `take`), so it must act as
    the bottom of the image rather than read a halo from padding."""
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    top = plane[:1].astype(jnp.int32)
    bot = plane[-1:].astype(jnp.int32)
    if bottom_edge_shard is None:
        bottom_edge_shard = n - 1
    if n == 1:
        return top, bot
    # Shift down: shard i receives shard i-1's bottom row.
    above = jax.lax.ppermute(bot, axis, [(i, i + 1) for i in range(n - 1)])
    # Shift up: shard i receives shard i+1's top row.
    below = jax.lax.ppermute(top, axis, [(i + 1, i) for i in range(n - 1)])
    above = jnp.where(idx == 0, top, above)
    below = jnp.where(idx >= bottom_edge_shard, bot, below)
    return above, below


def _shard_geometry(frame: bitstream.Frame, n_shards: int) -> int:
    """MCU rows per shard; requires mcus_y % n_shards == 0 (callers pad)."""
    if frame.mcus_y % n_shards != 0:
        raise JpegUnsupportedError(
            f"mcus_y={frame.mcus_y} not divisible by {n_shards} shards; "
            "pad the MCU-row count before sharding"
        )
    return frame.mcus_y // n_shards


@functools.lru_cache(maxsize=32)
def _build_sharded_transform(key: Tuple, n_shards: int, axis: str, fancy: bool):
    """Jitted shard_map'd transform for one frame geometry: per-shard
    coefficient grids in, per-shard RGB rows out, halo rows between devices.

    `key` carries `pad_mcu_rows`: extra all-zero MCU rows appended by
    decode_sharded so n_shards always divides the row count (SURVEY.md
    §7.1 M5). Shards past the true image emit junk that the final crop
    discards; the shard holding the true bottom edge acts as the bottom
    of the halo ring."""
    height, width, hv, pad_mcu_rows = key
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
    mcus_y_tot = frame.mcus_y + pad_mcu_rows
    if mcus_y_tot % n_shards != 0:
        raise JpegUnsupportedError(
            f"mcus_y={frame.mcus_y}+{pad_mcu_rows} pad not divisible by "
            f"{n_shards} shards"
        )
    mcu_rows_local = mcus_y_tot // n_shards

    def local_transform(coeffs: Sequence[jnp.ndarray], qtabs: Sequence[jnp.ndarray]):
        """Runs per shard under shard_map. coeffs[ci]:
        int32[local_block_rows, padded_wb, 64] zigzag."""
        my = jax.lax.axis_index(axis)
        planes = []
        for ci, c in enumerate(frame.components):
            grid = coeffs[ci]
            lbr = mcu_rows_local * c.v  # local block rows
            deq = transform.dequantize(grid.reshape(-1, 64), qtabs[ci])
            samples = transform.idct8x8_islow(deq)
            plane = transform.blocks_to_plane(samples, lbr, c.padded_wb)
            # Horizontal MCU-padding crop (static).
            plane = plane[:, : c.dwidth]
            # Vertical: replicate the true bottom edge over padding rows
            # so fancy upsampling sees the real edge (only affects the
            # shard that contains row dheight-1).
            local_h = lbr * 8
            row0 = my * local_h
            gidx = row0 + jnp.arange(local_h)
            src = jnp.clip(gidx, 0, c.dheight - 1) - row0
            # Padding rows can only replicate rows within the same shard.
            src = jnp.clip(src, 0, local_h - 1)
            plane = jnp.take(plane, src, axis=0)

            h_expand = frame.hmax // c.h
            v_expand = frame.vmax // c.v
            if v_expand == 2 and h_expand == 2 and fancy:
                bottom_edge = (c.dheight - 1) // local_h
                above, below = _exchange_halo(plane, axis, bottom_edge)
                plane = _h2v2_fancy_with_halo(plane, above, below)
            elif v_expand == 1 and h_expand == 2 and fancy:
                plane = transform.upsample_h2v1_fancy(plane)
            elif h_expand != 1 or v_expand != 1:
                plane = transform.upsample_int(plane, h_expand, v_expand)
            planes.append(plane[:, : frame.width])

        if frame.n_components == 1:
            return planes[0]
        if frame.n_components == 3:
            return transform.ycc_to_rgb(planes[0], planes[1], planes[2])
        return jnp.stack(planes, axis=-1)

    mesh = jax.make_mesh((n_shards,), (axis,))
    in_spec = ([P(axis) for _ in frame.components], [P() for _ in frame.components])
    fn = shard_map(
        local_transform,
        mesh=mesh,
        in_specs=in_spec,
        out_specs=P(axis),
        check_vma=False,
    )
    return jax.jit(fn), frame, mesh


def decode_sharded(
    data: bytes,
    n_shards: Optional[int] = None,
    config: DecodeConfig = DEFAULT_CONFIG,
    axis: str = "rows",
) -> np.ndarray:
    """Decode one image with its MCU rows sharded over the mesh
    (config 5). The entropy stage runs with the configured engine —
    restart-segmented streams go through the device wavefront kernel, so
    coefficients flow from the wavefront straight into the MCU-row
    shards; the transform stage exchanges upsampling halos between devices."""
    from ..decoder import _entropy_decode
    from ..stats import DecodeStats

    if n_shards is None:
        n_shards = jax.device_count()
    jpeg = bitstream.parse(data)
    frame = jpeg.frame
    # Pad the MCU-row count up to a multiple of n_shards with all-zero
    # rows (SURVEY.md §7.1 M5): every device stays in the ring — a
    # 17-MCU-row image on 8 devices runs 8 shards of 3 rows, not 1 shard
    # of 17. Padding shards' output never survives the final crop.
    pad_mcu_rows = (-frame.mcus_y) % n_shards

    # Entropy: device wavefront for restart-segmented baseline streams
    # (coefficients stay device-resident); for marker-free streams the
    # skeleton-scan path decodes lanes sharded over the mesh with the
    # DC-predictor base crossing shards via dc_prefix_fixup
    # (BASELINE.json:5 "DC-predictor state via collectives"); host
    # engines otherwise.
    coeffs = None
    if not frame.progressive and config.entropy_engine in ("auto", "wavefront"):
        from ..kernels import wavefront_pallas

        try:
            if len(jpeg.scans) == 1 and len(jpeg.scans[0].rst_offsets) == 0:
                # Lane mesh over the same devices as the row-sharded
                # transform, so the coefficients land where it runs.
                coeffs = wavefront_pallas.decode_norst_sharded(
                    jpeg, config,
                    mesh=jax.make_mesh((n_shards,), ("lanes",)),
                )
            else:
                comps, failures = wavefront_pallas.decode_batch_to_device(
                    [jpeg], config, strict=True
                )
                coeffs = comps[0]
        except JpegUnsupportedError:
            try:
                # Oversize restart segments: segmented skeleton split on
                # one device (coefficients stay device-resident).
                coeffs = wavefront_pallas.decode_norst_to_device(
                    jpeg, config
                )
            except JpegUnsupportedError:
                coeffs = None
    if coeffs is None:
        coeffs = _entropy_decode(jpeg, config, DecodeStats())

    key = (
        frame.height, frame.width,
        tuple((c.h, c.v) for c in frame.components), pad_mcu_rows,
    )
    fn, _, mesh = _build_sharded_transform(
        key, n_shards, axis, config.fancy_upsampling
    )
    grids = []
    for ci, c in enumerate(frame.components):
        # jnp.pad keeps wavefront-produced coefficients device-resident.
        g = jnp.asarray(coeffs[ci]).reshape(c.padded_hb, c.padded_wb, 64)
        if pad_mcu_rows:
            g = jnp.pad(g, ((0, pad_mcu_rows * c.v), (0, 0), (0, 0)))
        grids.append(g)
    qtabs = [jnp.asarray(jpeg.qtables[c.tq]) for c in frame.components]
    out = jax.block_until_ready(fn(grids, qtabs))
    if config.to_numpy:
        return np.asarray(out)[: frame.height, : frame.width]
    # The row-sharded device array, cropped by a slice (not a gather).
    return jax.lax.slice(
        out, (0, 0) + (0,) * (out.ndim - 2),
        (frame.height, frame.width) + out.shape[2:],
    )


# ---------------------------------------------------------------------------
# DC-predictor prefix fixup over the mesh axis (BASELINE.json:5)
# ---------------------------------------------------------------------------


def dc_prefix_fixup(local_dc_totals: jnp.ndarray, axis: str) -> jnp.ndarray:
    """Exclusive prefix-sum of per-shard DC-delta totals over `axis`.

    When one entropy stream is split at non-restart boundaries, each
    shard decodes DC *deltas* relative to an unknown incoming predictor.
    The true starting predictor of shard i is the sum of all previous
    shards' delta totals. Runs inside shard_map; local_dc_totals:
    int32[n_components] per shard; returns the same shape: the value to
    add to every DC coefficient this shard decoded.

    Implemented as a masked psum (one all-reduce): shard i sums
    contributions from shards j < i.
    """
    n = jax.lax.axis_size(axis)
    idx = jax.lax.axis_index(axis)
    # all_gather then mask: [n, n_components] totals from every shard.
    allv = jax.lax.all_gather(local_dc_totals, axis)  # [n, C]
    mask = (jnp.arange(n) < idx)[:, None]
    return jnp.sum(jnp.where(mask, allv, 0), axis=0)
