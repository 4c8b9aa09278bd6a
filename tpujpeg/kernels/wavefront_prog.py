"""Progressive scans on device (SURVEY.md §2.1 #10, §3.3): the four
T.81 §G scan kinds applied to a device-resident coefficient state by
block-synchronous wavefront kernels over restart-segment lanes (Pallas
on the Triton route, one lane per thread, the MCU axis a fori_loop —
the same design as wavefront_pallas).

Layering mirrors tpujpeg/huffman.py's progressive controller exactly
(it is the bit-exactness oracle — tests/test_prog_device.py):

  DC first   kernel: per-MCU lockstep DC symbol + EXTEND, pred<<Al
  DC refine  no kernel: one bit per block at a STATIC bit position, so
             the correction mask is a vectorized host unpack + device OR
  AC first   kernel: per-block (run,size)/EOBn state machine, lane-local
             EOB-run carried across MCUs; coefficients go to the output
             block by masked store
  AC refine  kernel: per-trip symbol + correction-bit chunk over the
             whole band, reading the prior coefficients of each block
             and emitting the corrected block

Every kernel reads its Huffman tables from a packed runtime operand
(wavefront_pallas.pack_tables), so one compiled chain serves every
table set of a scan-script shape (libjpeg writes optimized tables per
progressive file).

Scope: restart-segmented progressive streams (segments = lanes, the
same parallelism substrate as baseline, SURVEY.md §3.4). Marker-free
progressive scans fall back to the host engines.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import bitstream
from ..backend import pallas_interpret
from ..config import DEFAULT_CONFIG, DecodeConfig
from ..errors import (
    JpegSyntaxError,
    JpegTruncatedError,
    JpegUnsupportedError,
)
from .wavefront_pallas import (
    LANE_GROUP,
    MAX_WORDS,
    CanonTable,
    _ERR_BADCODE,
    _ERR_RUN,
    _ERR_TRUNC,
    _advance_regs,
    _barrier,
    _busy_any,
    _decode_symbol_win,
    _fill_rows_native,
    _lanes_major,
    _load_table,
    _num_warps,
    _pick_group,
    _receive_extend,
    _win_from_regs,
    _word,
    failures_from_err,
    pack_tables,
)

# ---------------------------------------------------------------------------
# Per-scan plan: restart segments -> lane rows (same layout as baseline).
# Batch-first: a ScanPlan covers scan index k of a GROUP of images whose
# scan scripts match — every image's restart segments become lanes of ONE
# kernel launch, so a batch of progressive files pays one dispatch per
# scan index instead of one per (image, scan).
# ---------------------------------------------------------------------------


def _seg_geometry(jpeg, scan):
    """(total_mcus, restart_interval, n_segments) for one scan, with the
    same validity checks every device-progressive path needs."""
    frame = jpeg.frame
    if scan.interleaved:
        total = frame.mcus_x * frame.mcus_y
    else:
        c0 = frame.components[scan.comp_indices[0]]
        total = c0.width_blocks * c0.height_blocks
    ri = scan.restart_interval or total
    n_seg = -(-total // ri)
    if len(scan.rst_offsets) + 1 < n_seg:
        raise JpegTruncatedError("missing restart segments")
    if n_seg == 1 and total > 1 and len(scan.data) > MAX_WORDS * 4 - 8:
        raise JpegUnsupportedError(
            "progressive scan without restart segmentation"
        )
    return total, ri, n_seg


def _stuffed_width(scan, n_seg) -> int:
    """Word row width that fits the longest segment (exact destuffed
    lengths when parse's fused walk ran, stuffed bound otherwise)."""
    if (
        scan.destuffed is not None
        and scan.dseg_starts is not None
        and len(scan.dseg_starts) >= n_seg + 1
    ):
        ds = scan.dseg_starts
        lens = ds[1 : n_seg + 1] - ds[:n_seg]
        return int(lens.max()) // 4 + 2 if n_seg else 2
    ro = np.asarray(scan.rst_offsets[: n_seg - 1], dtype=np.int64)
    offs_r = np.concatenate([ro, [len(scan.data)]])
    starts_r = np.concatenate([[0], ro + 2])
    stuffed = offs_r - starts_r
    return int(stuffed.max()) // 4 + 2 if n_seg else 2


class ScanPlan:
    """Lane plan for scan index k across a group of images. Lanes are
    image-major (image i's segments are contiguous); `img_view[i]` is
    (lane0, n_seg, rows, total_mcus) for slicing kernel outputs back to
    per-image block grids."""

    def __init__(self, jpegs, k: int):
        geo = [_seg_geometry(j, j.scans[k]) for j in jpegs]
        W = 2
        for j, (_total, _ri, n_seg) in zip(jpegs, geo):
            W = max(W, _stuffed_width(j.scans[k], n_seg))
        W = min(-(-W // 32) * 32, MAX_WORDS + 32)
        if W > MAX_WORDS:
            raise JpegUnsupportedError(
                f"progressive segment too long ({W} words)"
            )
        # Snap the row width to a coarse ladder so files that differ
        # only in payload density share one compiled chain (W is part
        # of the kernel's shape).
        for step in (32, 64, 128, 256, 384, MAX_WORDS):
            if W <= step:
                W = step
                break

        L = sum(n_seg for (_t, _r, n_seg) in geo)
        scan0 = jpegs[0].scans[k]
        refine = scan0.ss != 0 and scan0.ah != 0
        lane_group = _pick_group(L, REFINE_LANES if refine else LANE_GROUP)
        G = -(-L // lane_group)
        n_pad = G * lane_group
        bits = np.empty((n_pad, W), dtype=np.int32)
        seg_bits = np.zeros(n_pad, dtype=np.int32)
        lm = np.zeros(n_pad, np.int32)
        meta = np.zeros((L, 3), np.int32)
        self.img_view = []
        lane0 = 0
        for ii, (j, (total, ri, n_seg)) in enumerate(zip(jpegs, geo)):
            scan = j.scans[k]
            _fill_rows_native(
                scan, n_seg, W,
                bits[lane0 : lane0 + n_seg],
                seg_bits[lane0 : lane0 + n_seg],
            )
            fm = np.arange(n_seg, dtype=np.int64) * ri
            nm = np.minimum(ri, total - fm).astype(np.int32)
            lm[lane0 : lane0 + n_seg] = nm
            meta[lane0 : lane0 + n_seg, 0] = ii
            meta[lane0 : lane0 + n_seg, 1] = fm.astype(np.int32)
            meta[lane0 : lane0 + n_seg, 2] = nm
            self.img_view.append((lane0, n_seg, min(ri, total), total))
            lane0 += n_seg
        bits[lane0:] = -1

        self.bits = bits
        self.seg_bits = seg_bits
        self.lane_m = lm
        self.lane_meta = meta
        self.n_groups = G
        self.n_lanes = L
        self.n_words = W
        self.n_mcus = int(lm.max()) if L else 0
        self.lane_group = lane_group


def _tables_for_scan(scan, dc: bool) -> Tuple:
    out = []
    for sp in range(scan.n_comps):
        key = (0, scan.dc_ids[sp]) if dc else (1, scan.ac_ids[sp])
        if key not in scan.huff:
            raise JpegSyntaxError("missing Huffman table")
        out.append(CanonTable.from_spec(scan.huff[key]))
    return tuple(out)


def _lane_setup(lane_m_ref, bits_ref, lg: int, W: int):
    """Per-program lane indices and the zero-cursor register pair."""
    g = pl.program_id(0)
    sl = pl.ds(g * lg, lg)
    lane = jax.lax.broadcasted_iota(jnp.int32, (lg,), 0)
    rows = g * lg + lane
    zeros = jnp.zeros((lg,), jnp.int32)
    w0 = _word(bits_ref, rows, zeros, W)
    w1 = _word(bits_ref, rows, zeros + 1, W)
    return g, sl, lane, rows, zeros, lane_m_ref[sl], w0, w1


def _finish(err_ref, end_ref, sl, cur, err, lane_m):
    # Truncation: consumed beyond the segment (+7 pad bits legal).
    trunc = (cur > end_ref[sl] + 7) & (lane_m > 0)
    err_ref[sl] = err | jnp.where(trunc, _ERR_TRUNC, 0)


def _pallas(kernel, n_groups: int, out_shapes, lg: int, name: str):
    return pl.pallas_call(
        kernel,
        grid=(n_groups,),
        out_shape=out_shapes,
        interpret=pallas_interpret(),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(lg), num_stages=1
        ),
        name=name,
    )


def _table_operand(scan):
    """The packed Huffman tables ([n_scan_comps, TBL_WORDS]) one scan's
    kernel reads at run time: DC tables for a DC scan, else AC."""
    return jnp.asarray(pack_tables(_tables_for_scan(scan, dc=scan.ss == 0)))


# ---------------------------------------------------------------------------
# DC first kernel
# ---------------------------------------------------------------------------


def _run_dc_first(bits, lane_m, seg_bits, tbl, static, n_groups, n_mcus):
    """tbl: [n_scan_comps, TBL_WORDS] DC tables; static = (blk_sp, W,
    al, lane_group). Returns (out [G, M, B, group], err [G*group])."""
    blk_sp, W, al, lg = static
    B = len(blk_sp)
    n_sp = max(blk_sp) + 1

    def kernel(lane_m_ref, bits_ref, end_ref, tbl_ref, sp_ref, out_ref,
               err_ref):
        g, sl, _lane, rows, zeros, lane_m, w0, w1 = _lane_setup(
            lane_m_ref, bits_ref, lg, W
        )

        def mcu_step(m, carry):
            active = m < lane_m

            # One copy of the block code for every block position (its
            # scan component from sp_ref), as in the baseline kernel.
            def block_step(b, carry):
                cur, w0, w1, err = carry[:4]
                preds = carry[4:]
                sp = sp_ref[b]
                ok = active & (err == 0)
                win = _win_from_regs(w0, w1, cur)
                t, dlen = _decode_symbol_win(
                    win, _load_table(tbl_ref, sp), tbl_ref
                )
                bad = ok & ((dlen > 16) | (t > 15))
                t = jnp.where(t > 15, 0, t)
                diff = _receive_extend(win, dlen, t)
                pred = preds[0]
                for p in range(1, n_sp):
                    pred = jnp.where(sp == p, preds[p], pred)
                pred = pred + jnp.where(ok, diff, 0)
                preds = tuple(
                    jnp.where(sp == p, pred, preds[p]) for p in range(n_sp)
                )
                cur2 = cur + jnp.where(ok, dlen + t, 0)
                w0, w1 = _advance_regs(bits_ref, rows, w0, w1, cur, cur2, W)
                err = jnp.where(bad, _ERR_BADCODE, err)
                out_ref[g, m, b, :] = jnp.where(ok, pred << al, 0)
                return (cur2, w0, w1, err) + preds

            return jax.lax.fori_loop(0, B, block_step, carry)

        cur, _w0, _w1, err = jax.lax.fori_loop(
            0, n_mcus, mcu_step, (zeros, w0, w1, zeros) + (zeros,) * n_sp
        )[:4]
        _finish(err_ref, end_ref, sl, cur, err, lane_m)

    return _pallas(
        kernel, n_groups,
        (
            jax.ShapeDtypeStruct((n_groups, n_mcus, B, lg), jnp.int32),
            jax.ShapeDtypeStruct((n_groups * lg,), jnp.int32),
        ),
        lg, "prog_dc_first",
    )(lane_m, bits, seg_bits, tbl, jnp.asarray(np.asarray(blk_sp, np.int32)))


run_dc_first_jit = jax.jit(
    _run_dc_first, static_argnames=("static", "n_groups", "n_mcus")
)


# ---------------------------------------------------------------------------
# AC first kernel (single component, one block per MCU)
# ---------------------------------------------------------------------------


def _receive_raw(win, length, nbits):
    """nbits unsigned bits following the code (no EXTEND)."""
    after = (win << length.astype(jnp.uint32)).astype(jnp.uint32)
    return jnp.where(
        nbits > 0,
        (after >> (np.uint32(32) - nbits.astype(jnp.uint32))).astype(
            jnp.int32
        ),
        0,
    )


def _run_ac_first(bits, lane_m, seg_bits, tbl, static, n_groups, n_mcus):
    """tbl: [1, TBL_WORDS] AC table; static = (W, ss, se, al,
    lane_group). Returns (out [G, M, 64, group] zigzag with zeros
    outside the band, err [G*group])."""
    W, ss, se, al, lg = static
    interpret = pallas_interpret()

    def kernel(lane_m_ref, bits_ref, end_ref, tbl_ref, out_ref, err_ref):
        g, sl, lane, rows, zeros, lane_m, w0, w1 = _lane_setup(
            lane_m_ref, bits_ref, lg, W
        )
        tbl = _load_table(tbl_ref, 0)

        def mcu_step(m, carry):
            cur, w0, w1, err, eob = carry
            active = m < lane_m
            ok = active & (err == 0)
            skip = ok & (eob > 0)
            eob = jnp.where(skip, eob - 1, eob)
            busy0 = ok & ~skip
            for z in range(64):
                out_ref[g, m, z, :] = zeros
            _barrier(interpret)

            def cond(st):
                step, _cur, _k, _err = st[:4]
                return _busy_any(busy0 & (_k <= se) & (_err == 0)) & (
                    step < 80
                )

            def body(st):
                step, _cur, _k, _err, _eob, _w0, _w1 = st
                busy = busy0 & (_k <= se) & (_err == 0)
                win = _win_from_regs(_w0, _w1, _cur)
                rs, alen = _decode_symbol_win(win, tbl, tbl_ref)
                r = rs >> 4
                s = rs & 0x0F
                val = _receive_extend(win, alen, s)
                is_eob = (s == 0) & (r < 15)
                is_zrl = (s == 0) & (r == 15)
                nk = _k + jnp.where(s > 0, r, 0)
                plgpu.store(
                    out_ref.at[g, m, jnp.minimum(nk, 63), lane], val << al,
                    mask=busy & (s > 0) & (nk <= se),
                )
                extra = _receive_raw(win, alen, jnp.where(is_eob, r, 0))
                new_eob = jnp.left_shift(1, r) - 1 + extra
                _eob = jnp.where(busy & is_eob, new_eob, _eob)
                consumed = alen + jnp.where(
                    s > 0, s, jnp.where(is_eob, r, 0)
                )
                nc = _cur + jnp.where(busy, consumed, 0)
                _w0, _w1 = _advance_regs(bits_ref, rows, _w0, _w1, _cur, nc, W)
                _k = jnp.where(
                    busy,
                    jnp.where(is_eob, 65, jnp.where(is_zrl, _k + 16, nk + 1)),
                    _k,
                )
                _err = jnp.where(busy & (alen > 16), _ERR_BADCODE, _err)
                _err = jnp.where(busy & (s > 0) & (nk > se), _ERR_RUN, _err)
                return step + 1, nc, _k, _err, _eob, _w0, _w1

            _, cur, _k, err, eob, w0, w1 = jax.lax.while_loop(
                cond, body,
                (jnp.int32(0), cur, jnp.where(busy0, ss, 65), err, eob,
                 w0, w1),
            )
            return cur, w0, w1, err, eob

        cur, _w0, _w1, err, _eob = jax.lax.fori_loop(
            0, n_mcus, mcu_step, (zeros, w0, w1, zeros, zeros)
        )
        _finish(err_ref, end_ref, sl, cur, err, lane_m)

    return _pallas(
        kernel, n_groups,
        (
            jax.ShapeDtypeStruct((n_groups, n_mcus, 64, lg), jnp.int32),
            jax.ShapeDtypeStruct((n_groups * lg,), jnp.int32),
        ),
        lg, "prog_ac_first",
    )(lane_m, bits, seg_bits, tbl)


run_ac_first_jit = jax.jit(
    _run_ac_first, static_argnames=("static", "n_groups", "n_mcus")
)


# ---------------------------------------------------------------------------
# AC refine kernel: per trip, one (run,size)/EOBn symbol PLUS up to 32
# correction bits, vectorized over the whole 64-coefficient band.
#
# Given the band's zero/nonzero pattern, T.81 §G.1.2.3's serial advance
# is data-independent:
#   * the stop position after a (run,size) symbol is the (r+1)-th zero
#     (16th for ZRL) at or after k: one cumsum over the zeros + a count;
#   * every nonzero coefficient strictly before the stop consumes one
#     correction bit, in k order — its bit index is its RANK among
#     those nonzeros: a cumsum turns the 32-bit register window into
#     all the correction bits at once;
#   * an EOB tail is the same thing with the stop pinned past se.
# Blocks needing more than 32 correction bits for one symbol continue
# in chunks of 32 (rank windows) on later trips — rare in practice.
# ---------------------------------------------------------------------------

_MODE_SYMBOL = 0   # needs a Huffman symbol decoded
_MODE_RANGE = 1    # consuming a range's correction bits
_MODE_DONE = 2

# Lanes per AC-refine program (the band is a [64, lanes] tensor), one
# warp per 32 lanes as elsewhere. Measured on an H100 (PERF.md, PR 1):
# 32 lanes on one warp ran a 4 x 2048^2 group's largest refine scan in
# 1.71 ms; four warps took 3.52 ms, 128 lanes on four warps 1.98 ms.
REFINE_LANES = 32


def _run_ac_refine(bits, lane_m, seg_bits, prior, tbl, static, n_groups,
                   n_mcus):
    """prior: [G, M, 64, group] band state before this scan. tbl and
    static as in _run_ac_first. Returns (out [G, M, 64, group],
    err [G*group])."""
    W, ss, se, al, lg = static
    p1 = 1 << al
    m1 = (-1) << al

    def kernel(lane_m_ref, bits_ref, end_ref, prior_ref, tbl_ref, out_ref,
               err_ref):
        g, sl, _lane, rows, zeros, lane_m, w0, w1 = _lane_setup(
            lane_m_ref, bits_ref, lg, W
        )
        tbl = _load_table(tbl_ref, 0)
        kiota = jax.lax.broadcasted_iota(jnp.int32, (64, lg), 0)

        def substep(cv, cur, rw0, rw1, k, kstop, place, tail, eob, mode,
                    err, done):
            """One symbol + one <=32-bit correction chunk for every
            lane; cv is the [64, group] band block."""
            # --- Symbol decode (mode SYMBOL). ---
            dec = mode == _MODE_SYMBOL
            win = _win_from_regs(rw0, rw1, cur)
            rs, alen = _decode_symbol_win(win, tbl, tbl_ref)
            badc = dec & (alen > 16)
            rr = rs >> 4
            ds = rs & 0x0F
            bads = dec & (ds > 1)  # refine sizes are 0 or 1 (T.81 G.1.2.3)
            sign = _receive_raw(win, alen, jnp.where(ds > 0, 1, 0))
            nval = jnp.where(sign > 0, p1, m1)
            is_eob = (ds == 0) & (rr < 15)
            extra = _receive_raw(win, alen, jnp.where(is_eob, rr, 0))
            dec_bits = alen + jnp.where(
                ds > 0, 1, jnp.where(is_eob, rr, 0)
            )
            cur1 = cur + jnp.where(dec, dec_bits, 0)
            eob = jnp.where(
                dec & is_eob, jnp.left_shift(1, rr) + extra, eob
            )

            # Stop position: the (r+1)-th zero at/after k ((16)th for
            # ZRL) — or past the band for EOB / exhausted runs. One
            # windowed mask serves both jobs: run lanes count ZEROS in
            # [k..se], EOB/range lanes count NONZEROS in [k..kstop_eff)
            # — (cv==0) XOR ~run folds the two value tests into one.
            run = dec & ~is_eob
            in_lo = kiota >= k[None]
            kstop_eff = jnp.where(dec, se + 1, kstop)
            mask = (
                ((cv == 0) ^ (~run[None])) & in_lo
                & (kiota < kstop_eff[None])
            ).astype(jnp.int32)
            mcum = jnp.cumsum(mask, axis=0)
            # Count in the whole window (kstop_eff <= se+1 masks the
            # rows past the band).
            row_se = jnp.sum(mask, axis=0)
            target = jnp.where(ds > 0, rr + 1, 16)
            # mcum is monotone, so the count of rows with mcum < target
            # IS the 0-based index of the target-th zero (64 = not in
            # band).
            kstop_found = jnp.sum(
                (mcum < target[None]).astype(jnp.int32), axis=0
            )
            notfound = kstop_found >= 64
            err = jnp.where(badc | bads, _ERR_BADCODE, err)
            err = jnp.where(run & (ds > 0) & notfound, _ERR_RUN, err)
            kstop = jnp.where(
                dec, jnp.where(run & ~notfound, kstop_found, se + 1),
                kstop,
            )
            place = jnp.where(
                dec, jnp.where((ds > 0) & ~notfound, nval, 0), place
            )
            tail = jnp.where(dec, jnp.where(is_eob, 1, 0), tail)
            done = jnp.where(dec, 0, done)
            mode = jnp.where(dec, _MODE_RANGE, mode)
            rw0, rw1 = _advance_regs(bits_ref, rows, rw0, rw1, cur, cur1, W)

            # Total correction bits this range owes, closed form:
            # run-found lanes have exactly (target-1) zeros before the
            # stop, so nonzeros = span - zeros; everyone else counts
            # nonzeros directly.
            total_nz = jnp.where(
                run,
                jnp.where(
                    notfound, (se + 1 - k) - row_se,
                    kstop - k - (target - 1),
                ),
                row_se,
            )

            # --- Range correction bits (everyone now in RANGE): ranks
            # [done, done+32) of the range's nonzeros map to the
            # window's bits MSB-first. ---
            rng = (mode == _MODE_RANGE) & (err == 0)
            win2 = _win_from_regs(rw0, rw1, cur1)
            nz_j = (cv != 0) & in_lo & (kiota < kstop[None])
            # Rank of each nonzero among the range's nonzeros, 0-based:
            # decode lanes derive it from the zeros cumsum (positions -
            # zeros), range-continuation lanes read it directly.
            ncum = jnp.where(
                run[None], (kiota - k[None] + 1) - mcum, mcum
            )
            rank = ncum - 1 - done[None]
            in_chunk = nz_j & rng[None] & (rank >= 0) & (rank < 32)
            rank_c = jnp.clip(rank, 0, 31)
            bit = (
                (win2[None] >> (np.uint32(31) - rank_c.astype(jnp.uint32)))
                .astype(jnp.int32)
                & 1
            )
            do_fix = in_chunk & (bit > 0) & ((cv & p1) == 0)
            delta = jnp.where(cv >= 0, p1, m1)
            left = total_nz - done
            consumed = jnp.where(rng, jnp.clip(left, 0, 32), 0)
            complete = rng & (left <= 32)
            # Placement of the newly-significant coefficient at kstop
            # happens when its range completes (kstop <= se only for
            # placing lanes; EOB/ZRL ranges carry place == 0).
            placing = complete & (place != 0)
            cv = (
                cv
                + jnp.where(do_fix, delta, 0)
                + jnp.where(
                    (kiota == kstop[None]) & placing[None],
                    place[None], 0,
                )
            )
            cur2 = cur1 + consumed
            rw0, rw1 = _advance_regs(bits_ref, rows, rw0, rw1, cur1, cur2, W)

            # >32-bit ranges keep k/kstop and continue at done+32.
            done = jnp.where(rng & ~complete, done + 32, done)
            k = jnp.where(complete, kstop + 1, k)
            eob = jnp.where(complete & (tail > 0), eob - 1, eob)
            mode = jnp.where(
                complete,
                jnp.where((tail > 0) | (k > se), _MODE_DONE, _MODE_SYMBOL),
                mode,
            )
            mode = jnp.where(err != 0, _MODE_DONE, mode)
            return (cv, cur2, rw0, rw1, k, kstop, place, tail, eob,
                    mode, err, done)

        def mcu_step(m, carry):
            cur, w0, w1, err, eob = carry
            ok = (m < lane_m) & (err == 0)
            entry_tail = ok & (eob > 0)
            # Block entry: a pending EOB run means the whole band
            # [ss..se] is one correction-bit range (the tail);
            # otherwise decode.
            st = (
                prior_ref[g, m, :, :], cur, w0, w1,
                jnp.full((lg,), ss, jnp.int32),
                jnp.full((lg,), se + 1, jnp.int32),
                zeros, jnp.where(entry_tail, 1, 0), eob,
                jnp.where(
                    ok, jnp.where(entry_tail, _MODE_RANGE, _MODE_SYMBOL),
                    _MODE_DONE,
                ),
                err, zeros,
            )

            def cond(st):
                return _busy_any(st[10] != _MODE_DONE) & (st[0] < 256)

            def body(st):
                return (st[0] + 1,) + substep(*st[1:])

            st = jax.lax.while_loop(cond, body, (jnp.int32(0),) + st)[1:]
            out_ref[g, m, :, :] = st[0]
            # (cur, w0, w1, err, eob)
            return st[1], st[2], st[3], st[10], st[8]

        cur, _w0, _w1, err, _eob = jax.lax.fori_loop(
            0, n_mcus, mcu_step, (zeros, w0, w1, zeros, zeros)
        )
        _finish(err_ref, end_ref, sl, cur, err, lane_m)

    return _pallas(
        kernel, n_groups,
        (
            jax.ShapeDtypeStruct((n_groups, n_mcus, 64, lg), jnp.int32),
            jax.ShapeDtypeStruct((n_groups * lg,), jnp.int32),
        ),
        lg, "prog_ac_refine",
    )(lane_m, bits, seg_bits, prior, tbl)


run_ac_refine_jit = jax.jit(
    _run_ac_refine, static_argnames=("static", "n_groups", "n_mcus")
)


# ---------------------------------------------------------------------------
# Lane-layout <-> grid-layout conversions
# ---------------------------------------------------------------------------


def _grids_to_lanes_s(img_view, G: int, n_lanes: int, M: int, grids,
                      lane_group: int):
    """Per-image [height_blocks, width_blocks, 64] grids -> one
    [G, M, 64, group] kernel input (the AC-refine prior). Images' lanes
    are contiguous, so this is a concat, not a scatter."""
    chunks = []
    for (lane0, n_seg, rows, total), grid in zip(img_view, grids):
        flat = grid.reshape(-1, 64)
        pad = n_seg * rows - total
        if pad:
            flat = jnp.pad(flat, ((0, pad), (0, 0)))
        flat = flat.reshape(n_seg, rows, 64)
        if rows < M:
            flat = jnp.pad(flat, ((0, 0), (0, M - rows), (0, 0)))
        chunks.append(flat)
    lane_pad = G * lane_group - n_lanes
    if lane_pad:
        chunks.append(jnp.zeros((lane_pad, M, 64), chunks[0].dtype))
    flat = chunks[0] if len(chunks) == 1 else jnp.concatenate(chunks, axis=0)
    return flat.reshape(G, lane_group, M, 64).transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Scan dispatch over the device-resident coefficient state
# ---------------------------------------------------------------------------


def _check_err(err, plan: ScanPlan):
    errs = np.asarray(err).reshape(-1)[: plan.n_lanes]
    failures = failures_from_err(errs, plan.lane_meta)
    if failures:
        raise failures[min(failures)]


def _dc_refine_masks(jpeg, scan) -> List[Tuple[int, np.ndarray]]:
    """DC refinement has one STATIC bit per block, so no kernel: unpack
    the correction bits on the host into per-component OR-masks
    ([padded_blocks] int32, bit already shifted to position Al). The
    device work is a plain `state |= mask` — which is why the whole
    multi-scan sequence can compile as ONE jitted chain (the masks are
    data inputs, not control flow)."""
    frame = jpeg.frame
    total, ri, n_seg = _seg_geometry(jpeg, scan)
    al = scan.al
    pieces = bitstream.split_restart_segments(scan)
    bits_all = []
    mcu = 0
    bpm = (
        sum(
            frame.components[ci].h * frame.components[ci].v
            for ci in scan.comp_indices
        )
        if scan.interleaved
        else 1
    )
    for seg in pieces[:n_seg]:
        n_m = min(ri, total - mcu)
        need = n_m * bpm
        got = np.unpackbits(np.frombuffer(seg, np.uint8), count=None)
        if len(got) < need:
            raise JpegTruncatedError("DC refinement scan truncated")
        bits_all.append(got[:need])
        mcu += n_m
    bits_np = np.concatenate(bits_all) if bits_all else np.zeros(0, np.uint8)
    p1 = 1 << al
    masks: List[Tuple[int, np.ndarray]] = []
    if scan.interleaved:
        # bits laid out MCU-major, block-within-MCU minor.
        per_mcu = bits_np.reshape(total, bpm)
        b0 = 0
        for sp, ci in enumerate(scan.comp_indices):
            c = frame.components[ci]
            nb = c.h * c.v
            sub = per_mcu[:, b0 : b0 + nb]
            b0 += nb
            sub = sub.reshape(frame.mcus_y, frame.mcus_x, c.v, c.h)
            sub = sub.transpose(0, 2, 1, 3).reshape(
                c.padded_hb * c.padded_wb
            )
            masks.append((ci, sub.astype(np.int32) * p1))
    else:
        ci = scan.comp_indices[0]
        c = frame.components[ci]
        grid = np.zeros((c.padded_hb, c.padded_wb), np.int32)
        sub = bits_np.reshape(c.height_blocks, c.width_blocks)
        grid[: c.height_blocks, : c.width_blocks] = sub.astype(np.int32)
        masks.append((ci, grid.reshape(-1) * p1))
    return masks


# Light static descriptions of a group's scan script: everything the
# traced chain needs, with NO references to JpegData/Scan objects (a
# cached jit closure must not pin scan bitstreams in memory — the
# round-1 advisor flagged exactly that leak shape on the baseline
# chain cache).


@dataclasses.dataclass(frozen=True)
class _ScanStatic:
    kind: str  # 'dc_first' | 'dc_refine' | 'ac_first' | 'ac_refine'
    comp_indices: Tuple[int, ...]
    interleaved: bool
    ss: int
    se: int
    al: int
    blk_sp: Tuple[int, ...]  # dc_first only
    # Plan geometry (kernel scans only):
    G: int = 0
    M: int = 0
    W: int = 0
    n_lanes: int = 0
    img_view: Tuple = ()
    lane_group: int = LANE_GROUP


@dataclasses.dataclass(frozen=True)
class _GroupStatic:
    n_images: int
    mcus_x: int
    mcus_y: int
    # Per component: (h, v, padded_hb, padded_wb, height_blocks,
    # width_blocks)
    comps: Tuple[Tuple[int, int, int, int, int, int], ...]
    scans: Tuple[_ScanStatic, ...]
    frame_hw: Tuple[int, int] = (0, 0)  # true (height, width) for crop


def _comps_static(frame) -> Tuple:
    return tuple(
        (c.h, c.v, c.padded_hb, c.padded_wb, c.height_blocks,
         c.width_blocks)
        for c in frame.components
    )


def _scan_static(jpegs, k: int, plan: Optional[ScanPlan]) -> _ScanStatic:
    scan = jpegs[0].scans[k]
    frame = jpegs[0].frame
    is_dc = scan.ss == 0
    refining = scan.ah != 0
    if is_dc and refining:
        return _ScanStatic(
            "dc_refine", tuple(scan.comp_indices), scan.interleaved,
            scan.ss, scan.se, scan.al, (),
        )
    blk_sp: Tuple[int, ...] = ()
    if is_dc:
        bl: List[int] = []
        if scan.interleaved:
            for sp, ci in enumerate(scan.comp_indices):
                c = frame.components[ci]
                bl += [sp] * (c.h * c.v)
        else:
            bl = [0]
        blk_sp = tuple(bl)
        kind = "dc_first"
    else:
        kind = "ac_first" if not refining else "ac_refine"
    return _ScanStatic(
        kind, tuple(scan.comp_indices), scan.interleaved,
        scan.ss, scan.se, scan.al, blk_sp,
        G=plan.n_groups, M=plan.n_mcus, W=plan.n_words,
        n_lanes=plan.n_lanes, img_view=tuple(plan.img_view),
        lane_group=plan.lane_group,
    )


def _img_lanes_s(img_view: Tuple, flat, ii: int, B: int):
    lane0, n_seg, rows, total = img_view[ii]
    return flat[lane0 : lane0 + n_seg, :rows].reshape(-1, B)[:total]


def _scatter_dc_s(flat, sk: _ScanStatic, gs: _GroupStatic, dcs: List):
    """Write one image's DC-first output ([total_mcus, B]) into its
    per-component DC vectors. DC lives in a separate [padded_blocks]
    column, NOT in the [padded_blocks, 64] AC state: a column write
    into the big state (`.at[:, 0].set`) rewrites the whole array on
    every DC scan; the standalone vector is ~1/64 the traffic, and the
    transform stage merges it once (pipeline._build_batch)."""
    if sk.interleaved:
        b0 = 0
        for sp, ci in enumerate(sk.comp_indices):
            h, v, phb, pwb, _hb, _wb = gs.comps[ci]
            nb = h * v
            sub = flat[:, b0 : b0 + nb]
            b0 += nb
            sub = sub.reshape(gs.mcus_y, gs.mcus_x, v, h)
            sub = sub.transpose(0, 2, 1, 3).reshape(-1)
            dcs[ci] = sub
    else:
        ci = sk.comp_indices[0]
        _h, _v, phb, pwb, hb, wb = gs.comps[ci]
        grid = flat[:, 0].reshape(hb, wb)
        grid = jnp.pad(grid, ((0, phb - hb), (0, pwb - wb)))
        dcs[ci] = grid.reshape(-1)


def _apply_static(
    gs: _GroupStatic, sk: _ScanStatic, states: List[List], dcs: List[List],
    arrs, masks,
):
    """One scan of the group against the (traced or eager) coefficient
    states. states[i][ci] holds the AC coefficients ([padded_blocks,
    64] zigzag, column 0 always zero); dcs[i][ci] the DC column
    ([padded_blocks]) — kept separate so DC scans never pay a column
    write into the big state (see _scatter_dc_s). arrs = (bits, lane_m,
    seg_bits, tbl) for kernel scans, None for DC refinement; masks =
    per-image tuples of OR-masks for DC refinement, () otherwise.
    Returns the kernel's error vector, or None for DC refinement. Pure
    function of its inputs given the statics — the whole scan sequence
    jits as one chain."""
    if sk.kind == "dc_refine":
        for ii in range(gs.n_images):
            for j, mask in enumerate(masks[ii]):
                ci = sk.comp_indices[j] if sk.interleaved else sk.comp_indices[0]
                dcs[ii][ci] = dcs[ii][ci] | mask
        return None

    bits, lane_m, seg_bits, tbl = arrs
    if sk.kind == "dc_first":
        out, err = run_dc_first_jit(
            bits, lane_m, seg_bits, tbl,
            (sk.blk_sp, sk.W, sk.al, sk.lane_group), sk.G, sk.M,
        )
        B = len(sk.blk_sp)
        flat = _lanes_major(out)
        for ii in range(gs.n_images):
            _scatter_dc_s(
                _img_lanes_s(sk.img_view, flat, ii, B), sk, gs, dcs[ii]
            )
        return err

    # AC scans: single component (parser-enforced).
    ci = sk.comp_indices[0]
    _h, _v, phb, pwb, hb, wb = gs.comps[ci]
    static = (sk.W, sk.ss, sk.se, sk.al, sk.lane_group)

    if sk.kind == "ac_first":
        out, err = run_ac_first_jit(
            bits, lane_m, seg_bits, tbl, static, sk.G, sk.M,
        )
        flat = _lanes_major(out)
        for ii in range(gs.n_images):
            grid = _img_lanes_s(sk.img_view, flat, ii, 64).reshape(
                hb, wb, 64
            )
            full = states[ii][ci].reshape(phb, pwb, 64)
            full = full.at[:hb, :wb].add(grid)
            states[ii][ci] = full.reshape(-1, 64)
        return err

    # AC refine: prior band values ride into the kernel per block.
    fulls = []
    priors = []
    for ii in range(gs.n_images):
        full = states[ii][ci].reshape(phb, pwb, 64)
        fulls.append(full)
        priors.append(full[:hb, :wb])
    prior = _grids_to_lanes_s(
        sk.img_view, sk.G, sk.n_lanes, sk.M, priors, sk.lane_group
    )
    out, err = run_ac_refine_jit(
        bits, lane_m, seg_bits, prior, tbl, static, sk.G, sk.M,
    )
    flat = _lanes_major(out)
    for ii in range(gs.n_images):
        grid = _img_lanes_s(sk.img_view, flat, ii, 64).reshape(hb, wb, 64)
        full = fulls[ii].at[:hb, :wb].set(grid)
        states[ii][ci] = full.reshape(-1, 64)
    return err


def scan_group_key(jpeg: bitstream.JpegData) -> Tuple:
    """Images whose keys match can share every scan's kernel launch:
    same frame geometry and an identical scan script — kind, band,
    successive-approximation position, component, and the bytes of each
    Huffman table (one table operand serves every lane of a launch).
    Restart intervals and segment lengths may differ (lanes carry their
    own MCU counts). The compiled chain does not depend on the tables,
    so groups that differ only in them share one program."""
    frame = jpeg.frame
    parts: list = [
        frame.height, frame.width,
        tuple((c.h, c.v) for c in frame.components),
    ]
    for scan in jpeg.scans:
        is_dc = scan.ss == 0
        refining = scan.ah != 0
        if is_dc and refining:
            tabs: Tuple = ()  # no entropy tables in a DC refinement scan
        elif is_dc:
            tabs = tuple(
                _spec_bytes(scan.huff.get((0, scan.dc_ids[sp])))
                for sp in range(scan.n_comps)
            )
        else:
            tabs = (_spec_bytes(scan.huff.get((1, scan.ac_ids[0]))),)
        parts.append(
            (
                scan.interleaved, tuple(scan.comp_indices),
                scan.ss, scan.se, scan.ah, scan.al, tabs,
            )
        )
    return tuple(parts)


def _spec_bytes(spec) -> Optional[bytes]:
    if spec is None:
        return None
    return spec.counts.tobytes() + spec.values.tobytes()


# One jitted chain per group structure: the ENTIRE multi-scan decode
# (every scan kernel + every lane<->grid conversion + every state
# update) compiles as a single XLA program, so a 10-scan image costs
# one dispatch instead of dozens of eager op dispatches. Keyed by
# _GroupStatic, which
# holds plain tuples only (no bitstream references pinned).
_PROG_CHAIN_CACHE: "collections.OrderedDict[Tuple, object]" = (
    collections.OrderedDict()
)
_PROG_CHAIN_MAX = 32


def _prog_chain(gs: _GroupStatic):
    key = gs
    fn = _PROG_CHAIN_CACHE.get(key)
    if fn is not None:
        _PROG_CHAIN_CACHE.move_to_end(key)
        return fn

    def run(arrs, masks):
        return _run_scans(gs, arrs, masks)

    fn = jax.jit(run)
    _PROG_CHAIN_CACHE[key] = fn
    while len(_PROG_CHAIN_CACHE) > _PROG_CHAIN_MAX:
        _PROG_CHAIN_CACHE.popitem(last=False)
    return fn


def _run_scans(gs: _GroupStatic, arrs, masks):
    """Traced body shared by the entropy-only and to-RGB chains: zero
    states through every scan of the script."""
    states = [
        [
            jnp.zeros((phb * pwb, 64), jnp.int32)
            for (_h, _v, phb, pwb, _hb, _wb) in gs.comps
        ]
        for _ in range(gs.n_images)
    ]
    dcs = [
        [
            jnp.zeros((phb * pwb,), jnp.int32)
            for (_h, _v, phb, pwb, _hb, _wb) in gs.comps
        ]
        for _ in range(gs.n_images)
    ]
    errs = []
    for k, sk in enumerate(gs.scans):
        err = _apply_static(gs, sk, states, dcs, arrs[k], masks[k])
        if err is not None:
            errs.append(err)
    return states, dcs, tuple(errs)


def _prog_rgb_chain(gs: _GroupStatic, tkey: Tuple):
    """Like _prog_chain but the ONE jitted program continues through the
    transform stage: scan kernels + DC merges + dequant/IDCT +
    upsample/color. A progressive group decodes to RGB in a single
    dispatch, and one program lets XLA schedule the transform against
    the tail of the scan chain. tkey =
    (idct, fancy, color, packed, per_image_q)."""
    key = (gs, tkey, "rgb")
    fn = _PROG_CHAIN_CACHE.get(key)
    if fn is not None:
        _PROG_CHAIN_CACHE.move_to_end(key)
        return fn
    idct, fancy, color, packed, per_image_q = tkey

    def run(arrs, masks, qtabs):
        from . import pipeline as kp

        states, dcs, errs = _run_scans(gs, arrs, masks)
        n = gs.n_images
        ncomp = len(gs.comps)
        coeff_stack = [
            jnp.stack([states[i][ci] for i in range(n)])
            for ci in range(ncomp)
        ]
        dc_stack = [
            jnp.stack([dcs[i][ci] for i in range(n)])
            for ci in range(ncomp)
        ]
        frame_key = (
            gs.frame_hw[0], gs.frame_hw[1],
            tuple((h, v) for (h, v, *_rest) in gs.comps),
        )
        tfn = kp._build_batch(
            frame_key, idct, fancy, color,
            has_dc=True, packed=packed, per_image_q=per_image_q,
        )
        rgb = tfn(coeff_stack, qtabs, dc_stack)
        return rgb, errs

    fn = jax.jit(run)
    _PROG_CHAIN_CACHE[key] = fn
    while len(_PROG_CHAIN_CACHE) > _PROG_CHAIN_MAX:
        _PROG_CHAIN_CACHE.popitem(last=False)
    return fn


def _chain_statics(
    jpegs: Sequence[bitstream.JpegData],
    plans: Optional[List[Optional[ScanPlan]]] = None,
):
    """Shared host prep for the jitted whole-sequence chains: per-scan
    plans -> (gs, arrs, masks, kernel_plans). The scan statics carry no
    Huffman tables (they ride in arrs as packed operands), so one
    compiled chain serves every table set of this scan-script shape."""
    n_scans = len(jpegs[0].scans)
    if plans is None:
        plans = [
            None
            if jpegs[0].scans[k].ss == 0 and jpegs[0].scans[k].ah != 0
            else ScanPlan(jpegs, k)
            for k in range(n_scans)
        ]
    sks = tuple(
        _scan_static(jpegs, k, plans[k]) for k in range(n_scans)
    )
    gs = _GroupStatic(
        n_images=len(jpegs),
        mcus_x=jpegs[0].frame.mcus_x,
        mcus_y=jpegs[0].frame.mcus_y,
        comps=_comps_static(jpegs[0].frame),
        scans=sks,
        frame_hw=(jpegs[0].frame.height, jpegs[0].frame.width),
    )
    arrs = tuple(
        None if p is None
        else (
            jnp.asarray(p.bits), jnp.asarray(p.lane_m),
            jnp.asarray(p.seg_bits), _table_operand(jpegs[0].scans[k]),
        )
        for k, p in enumerate(plans)
    )
    masks = tuple(
        tuple(
            tuple(m for _ci, m in _dc_refine_masks(j, j.scans[k]))
            for j in jpegs
        )
        if sks[k].kind == "dc_refine"
        else ()
        for k in range(n_scans)
    )
    kernel_plans = [p for p in plans if p is not None]
    return gs, arrs, masks, kernel_plans


def build_chain_inputs(
    jpegs: Sequence[bitstream.JpegData],
    plans: Optional[List[Optional[ScanPlan]]] = None,
):
    """Host prep for the jitted whole-sequence chain: per-scan plans,
    the chain function, and its inputs. Returns (fn, arrs, masks,
    kernel_plans); call `fn(arrs, masks)` -> (states, dcs, errs), where
    errs aligns with kernel_plans for failure mapping. Benchmarks stage
    `arrs` on the device before the clock."""
    gs, arrs, masks, kernel_plans = _chain_statics(jpegs, plans)
    return _prog_chain(gs), arrs, masks, kernel_plans


def decode_all_scans_batch(
    jpegs: Sequence[bitstream.JpegData],
    config: DecodeConfig = DEFAULT_CONFIG,
) -> Tuple[List[Optional[List[jnp.ndarray]]], Dict[int, Exception]]:
    """Device-resident progressive entropy decode of a GROUP of images
    with matching `scan_group_key`s: scan k of every image decodes in
    one wavefront launch (SURVEY.md §2.1 #10, §3.3 — cross-image
    batching of the multi-scan controller), and the WHOLE scan sequence
    runs as one jitted chain. Returns (states, dcs, failures):
    states[i] is the per-component [padded_blocks, 64] zigzag AC grid
    list for image i (column 0 zero) and dcs[i] the matching
    [padded_blocks] DC columns — merged by the transform stage
    (pipeline.transform_batch(dcs=...)) or on host — or None when
    failures[i] holds its exception. Error vectors are read back once
    at the end — a bad image poisons only its own lanes."""
    for jpeg in jpegs:
        if not jpeg.frame.progressive:
            raise JpegUnsupportedError("not a progressive frame")
    fn, arrs, masks, kernel_plans = build_chain_inputs(jpegs)
    states, dcs, errs = fn(arrs, masks)
    failures: Dict[int, Exception] = {}
    for err, plan in zip(errs, kernel_plans):
        e = np.asarray(err).reshape(-1)[: plan.n_lanes]
        for img, exc in failures_from_err(e, plan.lane_meta).items():
            failures.setdefault(img, exc)
    for img in failures:
        states[img] = None
        dcs[img] = None
    return states, dcs, failures


def decode_all_scans_to_rgb_batch(
    jpegs: Sequence[bitstream.JpegData],
    config: DecodeConfig = DEFAULT_CONFIG,
    packed: bool = False,
    defer_errors: bool = False,
) -> Tuple[jnp.ndarray, str, object]:
    """Full progressive decode of a matching group as ONE jitted
    program: every scan kernel, the DC merges, dequant+IDCT and
    upsample/color in a single dispatch (the entropy-chain +
    separate-transform split cost an extra device round-trip per
    group, and XLA can overlap the transform with the scan tail).
    Returns (rgb, layout, failures): rgb[i] is image i's decode
    (garbage when failures has i), layout 'nhwc' or 'packed16' (the
    latter only when `packed` and the frame qualifies —
    pipeline.packed_layout_applies). Mixed per-image quantizers are
    fine (per-image dequant in XLA); Huffman tables must match across
    the group (scan_group_key). With defer_errors the third element is
    instead the opaque (errs, kernel_plans) pair for
    resolve_scan_errors — no readback happens, so a caller can
    dispatch many groups back to back and the device overlaps them."""
    from . import pipeline as kp

    for jpeg in jpegs:
        if not jpeg.frame.progressive:
            raise JpegUnsupportedError("not a progressive frame")
    gs, arrs, masks, kernel_plans = _chain_statics(jpegs)
    frame = jpegs[0].frame
    color = bitstream.color_space(jpegs[0])
    want_packed = packed and kp.packed_layout_applies(
        frame, config, color
    )
    qkeys = {
        tuple(j.qtables[c.tq].tobytes() for c in frame.components)
        for j in jpegs
    }
    per_image_q = len(qkeys) > 1
    if per_image_q:
        qtabs = [
            jnp.asarray(
                np.stack([j.qtables[c.tq] for j in jpegs])
            )
            for c in frame.components
        ]
    else:
        qtabs = [
            jnp.asarray(jpegs[0].qtables[c.tq]) for c in frame.components
        ]
    tkey = (
        config.idct, config.fancy_upsampling, color, want_packed,
        per_image_q,
    )
    fn = _prog_rgb_chain(gs, tkey)
    rgb, errs = fn(arrs, masks, qtabs)
    layout = "packed16" if want_packed else "nhwc"
    if defer_errors:
        # Async contract: nothing is read back here, so a caller can
        # DISPATCH several groups' chains before resolving any — on a
        # high-dispatch-latency runtime the groups then overlap on
        # device instead of serializing on per-group error syncs (the
        # common progressive batch is all singleton groups: libjpeg
        # optimizes Huffman tables per image).
        return rgb, layout, (errs, kernel_plans)
    return rgb, layout, resolve_scan_errors(errs, kernel_plans)


def resolve_scan_errors(errs, kernel_plans) -> Dict[int, Exception]:
    """Force the deferred error vectors (the first readback of the
    group's chain) and map them to per-image failures."""
    failures: Dict[int, Exception] = {}
    for err, plan in zip(errs, kernel_plans):
        e = np.asarray(err).reshape(-1)[: plan.n_lanes]
        for img, exc in failures_from_err(e, plan.lane_meta).items():
            failures.setdefault(img, exc)
    return failures


def decode_all_scans(
    jpeg: bitstream.JpegData, config: DecodeConfig = DEFAULT_CONFIG
) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Device-resident progressive entropy decode: every scan kind runs
    on device (DC refinement is a host bit-unpack + device OR — the bit
    positions are static). Returns (acs, dcs): per-component
    [padded_blocks, 64] zigzag AC grids (column 0 zero) and
    [padded_blocks] DC columns (device arrays)."""
    states, dcs, failures = decode_all_scans_batch([jpeg], config)
    if failures:
        raise failures[0]
    return states[0], dcs[0]
