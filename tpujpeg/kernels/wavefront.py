"""Wavefront Huffman entropy decoder on device (SURVEY.md §3.4, §7.2
hard-part 1; BASELINE.json:5 "wavefront Huffman entropy decoder").

One decode *lane* per restart segment: T.81 §E.2.4 resets DC predictors
and byte-aligns at every RSTn, so segments share no state and thousands
of lanes can advance in lockstep. Each wavefront step decodes one
Huffman symbol (code + magnitude bits) per lane from a shared packed
LUT, updates per-lane cursors/predictors, and appends at most one
coefficient per lane to step-indexed emission buffers; one sorted
scatter materializes the coefficient tensor after the loop (emission
positions are per-lane monotonic and globally unique, so the scatter
carries indices_are_sorted + unique_indices instead of serializing as
an unsorted scatter).

This is the plain XLA formulation (jnp ops under jax.jit +
lax.while_loop): it runs identically on the CPU (the conformance/test
path, config 1) and the GPU. All data-dependent control flow is masked
vector arithmetic. The public APIs keep coefficients ON DEVICE and hand
them straight to the transform.

Batching: any number of (image, scan) pairs merge into ONE launch —
lanes carry per-lane base offsets into concatenated bitstream/table/
output spaces, so a 1024-image bucket decodes as one wavefront
(SURVEY.md §3.5 "one wavefront launch over all images' segments").

Scope: baseline (sequential) scans. Progressive scans fall back to the
native host decoder (SURVEY.md §7.2 hard-part 5: refinement stays
host-side until profiling says otherwise).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import bitstream, huffman
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..errors import (
    JpegHuffmanError,
    JpegSyntaxError,
    JpegTruncatedError,
    JpegUnsupportedError,
)

_ERR_NONE = 0
_ERR_BADCODE = 1
_ERR_RUN = 2
_ERR_OVERFLOW = 3  # emission buffer exhausted; caller retries larger

# Symbols decoded per lane per while-loop iteration: amortizes the
# fixed per-iteration overhead of the compiled loop body.
UNROLL = 8


# ---------------------------------------------------------------------------
# Host-side plan construction
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchPlan:
    """Static device inputs for one merged wavefront launch covering any
    number of (image, scan) pairs."""

    words: np.ndarray          # uint32[nwords] big-endian bitstream (all)
    lut: np.ndarray            # uint16[8 * n_scans, 65536]
    out_block: np.ndarray      # int32[sum over scans of mcus*B]
    sp_tbl: np.ndarray         # int32[sum B] scan-component of block pos
    dc_row: np.ndarray         # int32[sum B] absolute LUT row for DC
    ac_row: np.ndarray         # int32[sum B] absolute LUT row for AC
    # Per-lane vectors [L]:
    seg_bit_start: np.ndarray  # int32
    seg_bit_len: np.ndarray    # int32
    first_mcu: np.ndarray      # int32 (scan-local)
    lane_mcus: np.ndarray      # int32
    obase: np.ndarray          # int32: out_block base of the lane's scan
    tbase: np.ndarray          # int32: sp/dc/ac table base of the scan
    bpm: np.ndarray            # int32: blocks per MCU of the lane's scan
    cbase: np.ndarray          # int32: image's global block base (uniform)
    lane_image: np.ndarray     # int32: image index (error reporting)
    n_lanes: int
    max_steps: int             # heuristic step bound (typical streams)
    hard_max_steps: int        # worst-case bound (retry on overflow)
    total_coeffs: int
    # Per image: coefficient base offset (in blocks) of each component.
    comp_block_offsets: List[List[int]]
    comp_blocks: List[List[int]]
    # When every merged scan shares one structure (geometry, block
    # order, table rows), a static tuple that lets the kernel compute
    # tables/output positions arithmetically instead of gathering.
    uniform: Optional[Tuple] = None


def _pack_luts(huff: Dict[Tuple[int, int], bitstream.HuffSpec]) -> np.ndarray:
    lut = np.zeros((8, 65536), dtype=np.uint16)
    for (tc, th), spec in huff.items():
        if tc > 1 or th > 3:
            continue
        t = huffman.HuffTable.from_spec(spec)
        lut[tc * 4 + th] = (
            t.lut_len.astype(np.uint16) << 8
        ) | t.lut_sym.astype(np.uint16)
    return lut


def _destuff(scan: bitstream.Scan) -> Tuple[np.ndarray, np.ndarray]:
    """Destuffed scan bytes + segment start offsets (native scanner when
    available, Python fallback — same output, tests assert so)."""
    try:
        from ..native import entropy as native_entropy

        buf, starts = native_entropy.destuff_segments(scan)
        return np.asarray(buf), np.asarray(starts)
    except Exception:
        pieces = bitstream.split_restart_segments(scan)
        buf = np.frombuffer(b"".join(pieces), dtype=np.uint8)
        starts = np.zeros(len(pieces) + 1, dtype=np.int64)
        np.cumsum([len(p) for p in pieces], out=starts[1:])
        return buf, starts


def build_batch_plan(jpegs: Sequence[bitstream.JpegData]) -> BatchPlan:
    """Merge every scan of every image into one wavefront launch."""
    word_chunks: List[np.ndarray] = []
    luts: List[np.ndarray] = []
    out_blocks: List[np.ndarray] = []
    sp_tbl: List[np.ndarray] = []
    dc_row: List[np.ndarray] = []
    ac_row: List[np.ndarray] = []
    lane_cols: List[List[np.ndarray]] = [[] for _ in range(9)]

    bit_base = 0       # bits consumed by previous chunks
    ob_base = 0        # out_block entries so far
    tb_base = 0        # table entries so far
    lut_base = 0       # LUT rows so far
    lut_cache: Dict[bytes, int] = {}  # content hash -> row base (dedup)
    _UNSET = object()
    uniform_sig: object = _UNSET
    coeff_base = 0     # coefficient-tensor blocks so far
    comp_block_offsets: List[List[int]] = []
    comp_blocks: List[List[int]] = []
    max_steps = 0
    hard_max_steps = 0

    for img_i, jpeg in enumerate(jpegs):
        frame = jpeg.frame
        if frame.progressive:
            raise JpegUnsupportedError(
                "wavefront engine decodes baseline scans only"
            )
        offs = []
        blocks = []
        acc = coeff_base
        for c in frame.components:
            offs.append(acc)
            blocks.append(c.padded_hb * c.padded_wb)
            acc += c.padded_hb * c.padded_wb
        comp_block_offsets.append(offs)
        comp_blocks.append(blocks)

        for scan in jpeg.scans:
            buf, seg_starts = _destuff(scan)

            interleaved = scan.n_comps > 1
            if interleaved:
                total_mcus = frame.mcus_x * frame.mcus_y
            else:
                c0 = frame.components[scan.comp_indices[0]]
                total_mcus = c0.width_blocks * c0.height_blocks
            ri = scan.restart_interval or total_mcus

            n_seg_needed = -(-total_mcus // ri)
            n_seg_have = len(seg_starts) - 1
            if n_seg_have < n_seg_needed:
                raise JpegTruncatedError(
                    f"scan has {n_seg_have} segments, needs {n_seg_needed}"
                )

            for sp in range(scan.n_comps):
                if (0, scan.dc_ids[sp]) not in scan.huff:
                    raise JpegSyntaxError(
                        f"missing DC Huffman table {scan.dc_ids[sp]}"
                    )
                if (1, scan.ac_ids[sp]) not in scan.huff:
                    raise JpegSyntaxError(
                        f"missing AC Huffman table {scan.ac_ids[sp]}"
                    )

            # Huffman LUT dedup: batches encoded with one tool share
            # tables, so identical packed LUTs reuse one row block.
            packed = _pack_luts(scan.huff)
            key = packed.tobytes()
            this_lut_base = lut_cache.get(key)
            if this_lut_base is None:
                this_lut_base = lut_base
                lut_cache[key] = lut_base
                luts.append(packed)
                lut_base += 8

            # Per-block-position metadata (T.81 §A.2.3 order).
            blk_meta: List[Tuple[int, int, int]] = []  # (ci, dv, dh)
            sps: List[int] = []
            dcs: List[int] = []
            acs: List[int] = []
            if interleaved:
                for sp, ci in enumerate(scan.comp_indices):
                    c = frame.components[ci]
                    for v in range(c.v):
                        for h in range(c.h):
                            sps.append(sp)
                            dcs.append(this_lut_base + 0 * 4 + scan.dc_ids[sp])
                            acs.append(this_lut_base + 1 * 4 + scan.ac_ids[sp])
                            blk_meta.append((ci, v, h))
            else:
                sps.append(0)
                dcs.append(this_lut_base + 0 * 4 + scan.dc_ids[0])
                acs.append(this_lut_base + 1 * 4 + scan.ac_ids[0])
                blk_meta.append((scan.comp_indices[0], 0, 0))
            B = len(blk_meta)

            # Structure signature for the uniform fast path: everything
            # the kernel would otherwise gather per symbol.
            if interleaved:
                geom = (
                    frame.mcus_x,
                    tuple(
                        (
                            ci, dv, dh,
                            frame.components[ci].v,
                            frame.components[ci].h,
                            frame.components[ci].padded_wb,
                            offs[ci] - offs[0],
                        )
                        for ci, dv, dh in blk_meta
                    ),
                )
            else:
                c0 = frame.components[scan.comp_indices[0]]
                geom = (
                    c0.width_blocks,
                    ((scan.comp_indices[0], 0, 0, 1, 1, c0.padded_wb,
                      offs[scan.comp_indices[0]] - offs[0]),),
                )
            sig = (interleaved, B, tuple(sps), tuple(dcs), tuple(acs), geom)
            if uniform_sig is _UNSET:
                uniform_sig = sig
            elif uniform_sig != sig:
                uniform_sig = None

            # Flat output block id per (mcu, block position).
            m = np.arange(total_mcus, dtype=np.int64)
            ob = np.empty((total_mcus, B), dtype=np.int64)
            if interleaved:
                my, mx = m // frame.mcus_x, m % frame.mcus_x
                for b, (ci, dv, dh) in enumerate(blk_meta):
                    c = frame.components[ci]
                    ob[:, b] = (
                        offs[ci]
                        + (my * c.v + dv) * c.padded_wb
                        + (mx * c.h + dh)
                    )
            else:
                ci = scan.comp_indices[0]
                c = frame.components[ci]
                by, bx = m // c.width_blocks, m % c.width_blocks
                ob[:, 0] = offs[ci] + by * c.padded_wb + bx

            # Lane vectors for this scan.
            L = n_seg_needed
            fm = (np.arange(L, dtype=np.int64) * ri).astype(np.int32)
            lm = np.minimum(ri, total_mcus - fm).astype(np.int32)
            sbs = (bit_base + seg_starts[:L] * 8).astype(np.int32)
            sbl = ((seg_starts[1 : L + 1] - seg_starts[:L]) * 8).astype(
                np.int32
            )
            cols = [
                sbs, sbl, fm, lm,
                np.full(L, ob_base, np.int32),
                np.full(L, tb_base, np.int32),
                np.full(L, B, np.int32),
                np.full(L, img_i, np.int32),
                np.full(L, offs[0], np.int32),
            ]
            for j in range(9):
                lane_cols[j].append(cols[j])

            # Step bounds. Hard: every block can emit 64 coefficients +
            # one EOB (65 symbols). Heuristic: photographic streams
            # average ~10-20 symbols/block and worst segments ~30; 32
            # covers them, and overflow is detected and retried at the
            # hard bound. The emission buffer (and the final sort, which
            # scales with the buffer) is sized by this bound.
            worst = int(lm.max()) * B * 65 if L else 0
            typ = int(lm.max()) * B * 32 if L else 0
            hard_max_steps = max(hard_max_steps, worst)
            max_steps = max(max_steps, min(worst, typ))

            # Bitstream chunk, padded to word alignment (bit_base stays
            # word-aligned so per-chunk seg starts add cleanly).
            nbytes = len(buf)
            pad = (-nbytes) % 4
            padded = np.concatenate(
                [buf, np.full(pad, 0xFF, dtype=np.uint8)]
            )
            word_chunks.append(padded.view(">u4").astype(np.uint32))
            bit_base += (nbytes + pad) * 8
            # Per-lane bit cursors are int32: a merged launch whose
            # concatenated bitstream reaches 2^31 bits (~256 MB) would
            # silently overflow and decode garbage. Refuse instead; the
            # caller chunks the batch or falls back.
            if bit_base + 64 >= 2**31:
                raise JpegUnsupportedError(
                    "xla wavefront: merged bitstream exceeds 2^31 bits; "
                    "split the batch"
                )

            out_blocks.append(ob.reshape(-1))
            sp_tbl.append(np.asarray(sps, np.int32))
            dc_row.append(np.asarray(dcs, np.int32))
            ac_row.append(np.asarray(acs, np.int32))
            ob_base += ob.size
            tb_base += B

        coeff_base = acc

    # Guard words so end-of-stream windows read 1-bits.
    word_chunks.append(np.full(2, 0xFFFFFFFF, dtype=np.uint32))

    return BatchPlan(
        words=np.concatenate(word_chunks),
        lut=np.concatenate(luts, axis=0),
        out_block=np.concatenate(out_blocks).astype(np.int32),
        sp_tbl=np.concatenate(sp_tbl),
        dc_row=np.concatenate(dc_row),
        ac_row=np.concatenate(ac_row),
        seg_bit_start=np.concatenate(lane_cols[0]),
        seg_bit_len=np.concatenate(lane_cols[1]),
        first_mcu=np.concatenate(lane_cols[2]),
        lane_mcus=np.concatenate(lane_cols[3]),
        obase=np.concatenate(lane_cols[4]),
        tbase=np.concatenate(lane_cols[5]),
        bpm=np.concatenate(lane_cols[6]),
        lane_image=np.concatenate(lane_cols[7]),
        cbase=np.concatenate(lane_cols[8]),
        n_lanes=sum(len(c) for c in lane_cols[0]),
        max_steps=max_steps,
        hard_max_steps=hard_max_steps,
        total_coeffs=coeff_base * 64,
        comp_block_offsets=comp_block_offsets,
        comp_blocks=comp_blocks,
        uniform=uniform_sig if uniform_sig is not _UNSET else None,
    )


# ---------------------------------------------------------------------------
# Device wavefront loop
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_lanes", "max_steps", "total_coeffs", "emit_buffers", "do_sort",
        "uniform",
    ),
)
def _wavefront_decode(
    words: jnp.ndarray,
    lut: jnp.ndarray,
    out_block: jnp.ndarray,
    sp_tbl: jnp.ndarray,
    dc_row: jnp.ndarray,
    ac_row: jnp.ndarray,
    seg_bit_start: jnp.ndarray,
    seg_bit_len: jnp.ndarray,
    first_mcu: jnp.ndarray,
    lane_mcus: jnp.ndarray,
    obase: jnp.ndarray,
    tbase: jnp.ndarray,
    bpm: jnp.ndarray,
    cbase: jnp.ndarray,
    n_lanes: int,
    max_steps: int,
    total_coeffs: int,
    emit_buffers: bool = True,
    do_sort: bool = True,
    uniform=None,
):
    """Run the lockstep wavefront. Returns (coeff_flat, err, consumed,
    mcu_done) — validation happens on host."""
    L = n_lanes
    n_iters = -(-max_steps // UNROLL)

    bit0 = seg_bit_start.astype(jnp.int32)
    wptr0 = bit0 >> 5
    state = dict(
        bit=bit0,                                 # absolute bit cursor
        mcu=first_mcu.astype(jnp.int32),          # scan-local MCU index
        mcu_done=jnp.zeros(L, jnp.int32),         # MCUs finished in lane
        blk=jnp.zeros(L, jnp.int32),              # block position in MCU
        k=jnp.zeros(L, jnp.int32),                # next coeff (0 => DC)
        pred=tuple(jnp.zeros(L, jnp.int32) for _ in range(4)),
        err=jnp.zeros(L, jnp.int32),
        # Cached 64-bit stream window (one refill gather per symbol
        # instead of two word gathers; the cursor advances <=27 bits per
        # symbol, so at most one word rolls over between symbols).
        wptr=wptr0,
        whi=jnp.take(words, wptr0, mode="clip"),
        wlo=jnp.take(words, wptr0 + 1, mode="clip"),
        step=jnp.asarray(0, jnp.int32),
    )
    if emit_buffers:
        state["out_pos"] = jnp.full(
            (n_iters * UNROLL, L), total_coeffs, jnp.int32
        )
        state["out_val"] = jnp.zeros((n_iters * UNROLL, L), jnp.int32)

    lut_flat = lut.reshape(-1).astype(jnp.int32)

    def active_mask(s):
        return (s["mcu_done"] < lane_mcus) & (s["err"] == _ERR_NONE)

    def cond(s):
        return jnp.any(active_mask(s)) & (s["step"] < n_iters)

    def static_sel(blk, values):
        """Select per-block-position constants with a static where-chain
        (no table gather); `values` is a python tuple of length B."""
        out = jnp.full_like(blk, values[0])
        for i in range(1, len(values)):
            out = jnp.where(blk == i, values[i], out)
        return out

    def micro_step(s):
        """Decode one symbol per active lane; returns (s', pos, val)."""
        act = active_mask(s)
        bit = s["bit"]
        blk = s["blk"]
        k = s["k"]
        is_dc = k == 0

        if uniform is not None:
            _, B_u, sps_u, dcs_u, acs_u, _geom = uniform
            sp = static_sel(blk, sps_u)
            lut_row = jnp.where(
                is_dc, static_sel(blk, dcs_u), static_sel(blk, acs_u)
            )
        else:
            ti = tbase + blk
            sp = jnp.take(sp_tbl, ti, mode="clip")
            lut_row = jnp.where(
                is_dc,
                jnp.take(dc_row, ti, mode="clip"),
                jnp.take(ac_row, ti, mode="clip"),
            )

        # Cached-window roll: at most one new word per symbol.
        w = bit >> 5
        adv = w > s["wptr"]
        whi = jnp.where(adv, s["wlo"], s["whi"])
        wptr = jnp.where(adv, s["wptr"] + 1, s["wptr"])
        wlo = jnp.where(adv, jnp.take(words, wptr + 1, mode="clip"), s["wlo"])
        sh = (bit & 31).astype(jnp.uint32)
        win = (whi << sh) | jnp.where(
            sh == 0, jnp.uint32(0), wlo >> (np.uint32(32) - sh)
        )
        idx16 = (win >> np.uint32(16)).astype(jnp.int32)
        entry = jnp.take(lut_flat, lut_row * 65536 + idx16, mode="clip")
        clen = entry >> 8
        sym = entry & 0xFF
        bad = act & (clen == 0)

        run = sym >> 4
        # DC magnitude category must be <= 15 (T.81 F.1.2.1.1) — flag
        # oversize symbols as bad codes (same taxonomy as the native /
        # Pallas / oracle engines) and clamp so shifts stay defined.
        bad = bad | (act & is_dc & (sym > 15))
        size = jnp.where(is_dc, jnp.minimum(sym, 15), sym & 0x0F)

        # Magnitude bits follow the code inside the same 32-bit window
        # (code<=16 bits + magnitude<=15 bits): shift the code out, then
        # take the top `size` bits. size==0 guarded (>>32 undefined).
        after = win << clen.astype(jnp.uint32)
        mag = jnp.where(
            size > 0,
            (after >> (np.uint32(32) - size.astype(jnp.uint32))).astype(
                jnp.int32
            ),
            0,
        )
        # EXTEND (T.81 §F.2.2.1).
        val = jnp.where(
            (size > 0) & (mag < (1 << jnp.maximum(size - 1, 0))),
            mag - (1 << size) + 1,
            mag,
        )

        # --- DC path: predictor update without scatter ---
        cur_pred = s["pred"][0]
        for i in (1, 2, 3):
            cur_pred = jnp.where(sp == i, s["pred"][i], cur_pred)
        new_pred_val = cur_pred + val
        dc_emit = act & is_dc
        pred = tuple(
            jnp.where(dc_emit & (sp == i), new_pred_val, s["pred"][i])
            for i in range(4)
        )

        # --- AC path ---
        is_eob = (~is_dc) & (size == 0) & (run != 15)
        is_zrl = (~is_dc) & (size == 0) & (run == 15)
        ac_k = k + jnp.where(is_dc, 0, run)
        ac_overrun = act & (~is_dc) & (size > 0) & (ac_k > 63)
        ac_emit = act & (~is_dc) & (size > 0) & (ac_k <= 63)

        if uniform is not None:
            # Closed-form output position: no out_block gather.
            _, _, _, _, _, (mcux_u, blkm_u) = uniform
            my = s["mcu"] // mcux_u
            mx = s["mcu"] - my * mcux_u
            row = my * static_sel(blk, tuple(b[3] for b in blkm_u)) + (
                static_sel(blk, tuple(b[1] for b in blkm_u))
            )
            col = mx * static_sel(blk, tuple(b[4] for b in blkm_u)) + (
                static_sel(blk, tuple(b[2] for b in blkm_u))
            )
            blk_out = (
                cbase
                + static_sel(blk, tuple(b[6] for b in blkm_u))
                + row * static_sel(blk, tuple(b[5] for b in blkm_u))
                + col
            )
        else:
            blk_out = jnp.take(
                out_block, obase + s["mcu"] * bpm + blk, mode="clip"
            )
        emit = dc_emit | ac_emit
        emit_k = jnp.where(is_dc, 0, ac_k)
        emit_val = jnp.where(is_dc, new_pred_val, val)
        # Non-emitting lanes point PAST the array: the final scatter
        # drops out-of-bounds positions, whereas a negative index would
        # WRAP and corrupt the last coefficient.
        pos = jnp.where(emit, blk_out * 64 + emit_k, total_coeffs)

        # Cursor advance.
        bit = bit + jnp.where(act, clen + size, 0)

        # Next-k state machine.
        k_next = jnp.where(
            is_dc,
            1,
            jnp.where(is_eob, 64, jnp.where(is_zrl, k + 16, ac_k + 1)),
        )
        block_done = act & (k_next >= 64)
        blk_next = jnp.where(block_done, blk + 1, blk)
        mcu_wrap = blk_next >= bpm
        blk_next = jnp.where(mcu_wrap, 0, blk_next)
        mcu_next = jnp.where(block_done & mcu_wrap, s["mcu"] + 1, s["mcu"])
        mcu_done = s["mcu_done"] + jnp.where(block_done & mcu_wrap, 1, 0)
        k_next = jnp.where(block_done, 0, k_next)

        err = s["err"]
        err = jnp.where(bad, _ERR_BADCODE, err)
        err = jnp.where(ac_overrun, _ERR_RUN, err)

        s2 = dict(
            s,
            bit=jnp.where(act, bit, s["bit"]),
            mcu=jnp.where(act, mcu_next, s["mcu"]),
            mcu_done=jnp.where(act, mcu_done, s["mcu_done"]),
            blk=jnp.where(act, blk_next, s["blk"]),
            k=jnp.where(act, k_next, s["k"]),
            pred=pred,
            err=err,
            wptr=wptr,
            whi=whi,
            wlo=wlo,
        )
        return s2, pos, emit_val

    def body(s):
        chunk_pos = []
        chunk_val = []
        for _ in range(UNROLL):
            s, pos, val = micro_step(s)
            chunk_pos.append(pos)
            chunk_val.append(val)
        s = dict(s, step=s["step"] + 1)
        if not emit_buffers:
            # Ablation mode: loop cost without emission-buffer updates
            # (keep a data dependence so nothing dead-codes away).
            return dict(s, err=s["err"] | (chunk_pos[0] >> 31))
        row = (s["step"] - 1) * UNROLL
        out_pos = jax.lax.dynamic_update_slice(
            s["out_pos"], jnp.stack(chunk_pos), (row, 0)
        )
        out_val = jax.lax.dynamic_update_slice(
            s["out_val"], jnp.stack(chunk_val), (row, 0)
        )
        return dict(s, out_pos=out_pos, out_val=out_val)

    final = jax.lax.while_loop(cond, body, state)
    # Lanes still active at the iteration cap exhausted the emission
    # buffer (heuristic bound): flag for the caller's hard-bound retry.
    err = jnp.where(
        active_mask(final) & (final["step"] >= n_iters),
        _ERR_OVERFLOW,
        final["err"],
    )
    if emit_buffers and do_sort:
        # Emission positions are monotonic per lane and each coefficient
        # is written at most once, so a global sort yields unique
        # ascending indices (empty slots = total_coeffs sort to the
        # tail) and the scatter carries indices_are_sorted +
        # unique_indices instead of serializing as an unsorted scatter.
        pos_s, val_s = jax.lax.sort(
            (final["out_pos"].reshape(-1), final["out_val"].reshape(-1)),
            num_keys=1,
        )
        coeff = jnp.zeros(total_coeffs, jnp.int32).at[pos_s].set(
            val_s, mode="drop", unique_indices=True, indices_are_sorted=True
        )
    else:
        coeff = jnp.zeros(total_coeffs, jnp.int32) + final["bit"][0]
    consumed = final["bit"] - seg_bit_start
    return coeff, err, consumed, final["mcu_done"]


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------


def _run_plan(plan: BatchPlan, max_steps: Optional[int] = None):
    return _wavefront_decode(
        jnp.asarray(plan.words),
        jnp.asarray(plan.lut),
        jnp.asarray(plan.out_block),
        jnp.asarray(plan.sp_tbl),
        jnp.asarray(plan.dc_row),
        jnp.asarray(plan.ac_row),
        jnp.asarray(plan.seg_bit_start),
        jnp.asarray(plan.seg_bit_len),
        jnp.asarray(plan.first_mcu),
        jnp.asarray(plan.lane_mcus),
        jnp.asarray(plan.obase),
        jnp.asarray(plan.tbase),
        jnp.asarray(plan.bpm),
        jnp.asarray(plan.cbase),
        n_lanes=plan.n_lanes,
        max_steps=max_steps if max_steps is not None else plan.max_steps,
        total_coeffs=plan.total_coeffs,
        uniform=plan.uniform,
    )


def _validate(plan: BatchPlan, err, consumed, mcu_done) -> Dict[int, Exception]:
    """Map lane-level failures to per-image exceptions (SURVEY.md §5
    fault isolation: a corrupt image never kills the batch)."""
    err = np.asarray(err)
    consumed = np.asarray(consumed)
    mcu_done = np.asarray(mcu_done)
    failures: Dict[int, Exception] = {}

    def flag(mask: np.ndarray, make):
        for lane in np.nonzero(mask)[0]:
            img = int(plan.lane_image[lane])
            if img not in failures:
                failures[img] = make(int(lane), img)

    flag(
        err == _ERR_BADCODE,
        lambda l, i: JpegHuffmanError(
            f"invalid Huffman code in segment {l} (image {i})"
        ),
    )
    flag(
        err == _ERR_RUN,
        lambda l, i: JpegHuffmanError(
            f"AC run past end of block in segment {l} (image {i})"
        ),
    )
    # Overrun: consumed more bits than the segment holds (a trailing
    # partial byte of padding is legal, T.81 §F.1.2.3).
    flag(
        consumed > plan.seg_bit_len + 7,
        lambda l, i: JpegTruncatedError(
            f"entropy segment {l} truncated (image {i})"
        ),
    )
    flag(
        err == _ERR_OVERFLOW,
        lambda l, i: JpegTruncatedError(
            f"segment {l} exceeded the symbol bound (image {i})"
        ),
    )
    flag(
        mcu_done < plan.lane_mcus,
        lambda l, i: JpegTruncatedError(
            f"wavefront decode did not converge in segment {l} (image {i})"
        ),
    )
    return failures


def decode_batch_to_device(
    jpegs: Sequence[bitstream.JpegData],
    config: DecodeConfig = DEFAULT_CONFIG,
    strict: bool = True,
) -> Tuple[List[Optional[List[jnp.ndarray]]], Dict[int, Exception]]:
    """Decode all scans of all images in ONE wavefront launch. Returns
    (per-image per-component [padded_blocks, 64] int32 device arrays —
    left on device to feed the transform kernels directly — with failed
    images as None, and the image->exception map). strict=True raises
    the first failure instead."""
    plan = build_batch_plan(jpegs)
    coeff, err, consumed, mcu_done = _run_plan(plan)
    if (
        plan.hard_max_steps > plan.max_steps
        and (np.asarray(err) == _ERR_OVERFLOW).any()
    ):
        # Unusually dense stream: rerun at the worst-case symbol bound.
        coeff, err, consumed, mcu_done = _run_plan(
            plan, max_steps=plan.hard_max_steps
        )
    failures = _validate(plan, err, consumed, mcu_done)
    if strict and failures:
        raise failures[min(failures)]

    out: List[Optional[List[jnp.ndarray]]] = []
    for i, (offs, blocks) in enumerate(
        zip(plan.comp_block_offsets, plan.comp_blocks)
    ):
        if i in failures:
            out.append(None)
            continue
        comps = []
        for off, nb in zip(offs, blocks):
            comps.append(coeff[off * 64 : (off + nb) * 64].reshape(nb, 64))
        out.append(comps)
    return out, failures


def decode_all_scans(
    jpeg: bitstream.JpegData, config: DecodeConfig = DEFAULT_CONFIG
) -> List[np.ndarray]:
    """Single-image entry matching the other entropy engines' contract
    (numpy coefficient arrays)."""
    comps, _ = decode_batch_to_device([jpeg], config, strict=True)
    return [np.asarray(c) for c in comps[0]]
