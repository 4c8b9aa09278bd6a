"""Block-synchronous wavefront Huffman decoder as one Pallas kernel on the
Triton route (SURVEY.md §7.2 hard-part 1 — the entropy hot path;
BASELINE.json:5 "wavefront Huffman entropy decoder ... into HBM").

Why a second formulation: the XLA wavefront (wavefront.py) sends every
lane's state through device memory on each trip of its while_loop and
ends in a sorted scatter. This kernel keeps a lane's whole decode state
in registers:

  * one decode lane (a restart segment, or a skeleton-split piece of a
    marker-free scan) per thread; a program covers `lane_group` lanes
    and walks the MCU axis in a fori_loop, so the cursor, the 64-bit
    window, the DC predictors and the error flags are loop carries;
  * the B block positions of an MCU are a static python loop, so
    components and geometry are compile-time constants;
  * within a block, the DC symbol is a lockstep step for every lane and
    the AC symbols run under a while_loop with per-lane done masks;
  * Huffman decode is canonical (T.81 F.2.2.3): code length from 16
    maxcode comparisons, the symbol by one gather from the packed table
    operand (pack_tables);
  * each lane loads its bitstream words by index from device memory;
  * AC coefficients go to memory by masked store — straight into the
    coefficient output (emit='coeff'), or into a per-lane 64-word block
    that the fused dequant + islow IDCT epilogue reads back
    (emit='pixels').

Scope: uniform batches (every scan shares geometry/tables — the batch
bucket case). Non-uniform batches use the XLA wavefront or the native
host decoder; segments longer than MAX_WORDS are split by the host
skeleton scan (build_norst_plan).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
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
    JpegHuffmanError,
    JpegSyntaxError,
    JpegTruncatedError,
    JpegUnsupportedError,
)
from . import wavefront as wf_xla

# Lanes per program on the GPU: one lane per thread, LANE_GROUP // 32
# warps per program. Measured on an H100 (PERF.md, PR 1): 64, 128 and
# 256 lanes ran within 6% of each other, 64 fastest.
LANE_GROUP = 64
MAX_WORDS = 512            # per-lane bitstream words cap (plan bound)
MAX_QSETS = 8              # distinct quantizer sets one fused launch takes
# One packed Huffman table (pack_tables): maxcode[0:17],
# valoffset[32:49], huffval[64:320].
TBL_WORDS = 320


def _pick_group(n_lanes: int, device_group: int = LANE_GROUP) -> int:
    """Lanes per program. On the GPU the kernel's fixed power of two,
    `device_group`. In interpret mode (CPU tests) the kernel executes real
    vector work proportional to the group, and padding a tiny test
    image's ~30 lanes to a device-sized group made every interpret-mode
    kernel pay that many times the arithmetic (it once made the cold
    suite hours long), so the group shrinks to the real lane count,
    rounded up to the power of two the Triton route wants."""
    if pallas_interpret():
        return max(8, 1 << max(n_lanes - 1, 0).bit_length())
    return device_group


def _num_warps(lane_group: int) -> int:
    return max(1, lane_group // 32)


def _barrier(interpret: bool) -> None:
    """Orders this program's global-memory stores before its later loads
    of the same words by other threads (a no-op in interpret mode,
    where a program is one sequential trace)."""
    if not interpret:
        plgpu.debug_barrier()


_ERR_BADCODE = 1
_ERR_RUN = 2
_ERR_TRUNC = 4


# ---------------------------------------------------------------------------
# Huffman tables: canonical constants, packed as one kernel operand
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CanonTable:
    """Canonical decode constants for one Huffman table: maxcode /
    valoffset per code length (T.81 F.2.2.3) + the symbol list."""

    maxcode: Tuple[int, ...]    # [17], -1 where no codes
    valoffset: Tuple[int, ...]  # [17]
    huffval: Tuple[int, ...]    # [256] padded

    @staticmethod
    def from_spec(spec: bitstream.HuffSpec) -> "CanonTable":
        key = spec.counts.tobytes() + spec.values.tobytes()
        hit = _CANON_CACHE.get(key)
        if hit is not None:
            return hit
        out = CanonTable._build(spec)
        _CANON_CACHE[key] = out
        return out

    @staticmethod
    def _build(spec: bitstream.HuffSpec) -> "CanonTable":
        maxcode = [-1] * 17
        valoffset = [0] * 17
        code = 0
        k = 0
        for l in range(1, 17):
            n = int(spec.counts[l - 1])
            if n:
                valoffset[l] = k - code
                code += n
                k += n
                maxcode[l] = code - 1
            code <<= 1
        hv = [int(v) for v in spec.values] + [0] * (256 - len(spec.values))
        return CanonTable(tuple(maxcode), tuple(valoffset), tuple(hv))


_CANON_CACHE: Dict[bytes, "CanonTable"] = {}


def pack_tables(tables: Sequence[CanonTable]) -> np.ndarray:
    """[n, TBL_WORDS] int32 operand: per table maxcode at [0:17] (-1
    where a length has no codes), valoffset at [32:49], huffval at
    [64:320]."""
    out = np.zeros((len(tables), TBL_WORDS), np.int32)
    for t, tb in enumerate(tables):
        out[t, 0:17] = tb.maxcode
        out[t, 32:49] = tb.valoffset
        out[t, 64:320] = tb.huffval
    return out


def _load_table(tbl_ref, t: int):
    """Table t's maxcode/valoffset as scalars, read once per program
    (outside the hot loop); huffval stays in memory for the gather."""
    mc = [None] + [tbl_ref[t, l] for l in range(1, 17)]
    vo = [None] + [tbl_ref[t, 32 + l] for l in range(1, 17)]
    return t, mc, vo


def _decode_symbol_win(win, tbl, tbl_ref):
    """One canonical Huffman symbol for every lane from a ready 32-bit
    window. Returns (sym, code_len) — code_len 17 marks an invalid
    code."""
    t, mc, vo = tbl
    length = jnp.full(win.shape, 17, jnp.int32)
    idx = jnp.zeros(win.shape, jnp.int32)
    # Walk lengths high to low so the SHORTEST valid length wins; the
    # huffval index (code + valoffset) rides along in the same pass.
    # maxcode -1 (no codes of that length) never matches: peek >= 0.
    for l in range(16, 0, -1):
        peek = (win >> np.uint32(32 - l)).astype(jnp.int32)
        sel = peek <= mc[l]
        length = jnp.where(sel, l, length)
        idx = jnp.where(sel, peek + vo[l], idx)
    idx = jnp.clip(idx, 0, 255)
    return tbl_ref[t, 64 + idx], length


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BlockPlan:
    bits: np.ndarray        # int32[G*group, W] per-lane bitstream rows
    seg_bits: np.ndarray    # int32[G*group] true bit length per lane
    lane_m: np.ndarray      # int32[G*group] MCUs per lane
    n_groups: int
    n_mcus: int             # MCU rounds (max lane MCUs)
    n_words: int            # W
    blocks_per_mcu: int
    # Static per-block-position: (comp_index, dc CanonTable, ac CanonTable)
    blk_tables: Tuple[Tuple[int, CanonTable, CanonTable], ...]
    # Static per-scan-component (ci, h, v) in scan order — the pixels
    # emit layout writes one output per scan component, tiled
    # [v*8 rows, h*2 words] per MCU. Non-interleaved scans use (ci,1,1).
    comp_hv: Tuple[Tuple[int, int, int], ...]
    # Geometry for assembly:
    frame_key: Tuple
    lane_meta: np.ndarray   # int32[L, 3]: (img, first_mcu, n_mcus)
    n_lanes: int
    images: int
    # All distinct quantizer sets in the batch + each image's index into
    # them: the pixels-mode kernel selects dequant constants per lane by
    # one-hot over qsets, so a q85/q86 pair shares one fused launch.
    qsets: Tuple[Tuple[Tuple[int, ...], ...], ...] = ()
    img_qset: Tuple[int, ...] = ()
    lane_qset: Optional[np.ndarray] = None  # int32[G*group]
    # No-restart plans only: starting bit of each lane within its word
    # row (lanes split at skeleton-scan bit offsets).
    bit0: Optional[np.ndarray] = None  # int32[G*group]
    # No-restart plans only: ABSOLUTE DC predictor value per component
    # at each lane's first MCU, computed by the host skeleton scan. The
    # kernel primes its predictors with it, so lanes decode TRUE DCs —
    # the fused pixels emit (IDCT in-kernel) works and coeff mode needs
    # no post-hoc prefix fixup.
    lane_dc0: Optional[np.ndarray] = None  # int32[4, G*group]
    norst_every: int = 0
    # Marker-segment id per lane + first lane of each marker segment:
    # DC predictors reset at marker boundaries, so the prefix fixup is a
    # SEGMENTED exclusive cumsum over these groups.
    lane_seg: Optional[np.ndarray] = None  # int64[L]
    seg_first: Optional[np.ndarray] = None  # int64[n_marker_segments]
    # Lanes per program this plan's arrays are padded for (_pick_group);
    # kernels and assembly read it from here.
    lane_group: int = LANE_GROUP

    def static_key(self, emit: str) -> Tuple:
        """The static config tuple run_wavefront/_make_kernel key on."""
        if emit == "coeff":
            return (
                self.blocks_per_mcu, self.blk_tables, self.n_words,
                self.n_mcus, "coeff", None, (), self.lane_group,
            )
        return (
            self.blocks_per_mcu, self.blk_tables, self.n_words,
            self.n_mcus, "pixels", self.qsets, self.comp_hv,
            self.lane_group,
        )


def _comp_hv_of(frame, scan) -> Tuple[Tuple[int, int, int], ...]:
    """(ci, h, v) per scan component for the pixels emit layout."""
    if scan.interleaved:
        return tuple(
            (ci, frame.components[ci].h, frame.components[ci].v)
            for ci in scan.comp_indices
        )
    return ((scan.comp_indices[0], 1, 1),)


def _blk_tables_of(frame, scan) -> Tuple[Tuple[int, CanonTable, CanonTable], ...]:
    """(ci, dc table, ac table) per block position of one MCU."""
    tables: List[Tuple[int, CanonTable, CanonTable]] = []
    if scan.interleaved:
        for sp, ci in enumerate(scan.comp_indices):
            c = frame.components[ci]
            dk, ak = (0, scan.dc_ids[sp]), (1, scan.ac_ids[sp])
            if dk not in scan.huff or ak not in scan.huff:
                raise JpegSyntaxError("missing Huffman table")
            dct = CanonTable.from_spec(scan.huff[dk])
            act = CanonTable.from_spec(scan.huff[ak])
            tables += [(ci, dct, act)] * (c.v * c.h)
    else:
        dk, ak = (0, scan.dc_ids[0]), (1, scan.ac_ids[0])
        if dk not in scan.huff or ak not in scan.huff:
            raise JpegSyntaxError("missing Huffman table")
        tables.append(
            (
                scan.comp_indices[0],
                CanonTable.from_spec(scan.huff[dk]),
                CanonTable.from_spec(scan.huff[ak]),
            )
        )
    return tuple(tables)


def build_block_plan(
    jpegs: Sequence[bitstream.JpegData],
    min_words: int = 0,
) -> BlockPlan:
    """Uniform-batch plan for the Pallas kernel. Raises
    JpegUnsupportedError when the batch doesn't fit the kernel's scope
    (caller falls back to the XLA wavefront / native decoder)."""
    if not jpegs:
        raise JpegUnsupportedError("empty batch")
    f0 = jpegs[0].frame
    key0 = (
        f0.height, f0.width, tuple((c.h, c.v) for c in f0.components),
    )

    seg_rows: List = []
    lane_meta: List[np.ndarray] = []
    blk_tables: Optional[Tuple] = None
    max_words = 0
    max_mcus = 0
    qset_index: Dict[Tuple, int] = {}
    qset_values: List[Tuple] = []
    img_qset: List[int] = []

    for img_i, jpeg in enumerate(jpegs):
        frame = jpeg.frame
        if frame.progressive:
            raise JpegUnsupportedError("pallas wavefront: baseline only")
        key = (
            frame.height, frame.width,
            tuple((c.h, c.v) for c in frame.components),
        )
        if key != key0:
            raise JpegUnsupportedError("pallas wavefront: mixed geometry")
        if len(jpeg.scans) != 1:
            raise JpegUnsupportedError("pallas wavefront: one scan only")
        scan = jpeg.scans[0]
        if not scan.interleaved and frame.n_components != 1:
            raise JpegUnsupportedError(
                "pallas wavefront: non-interleaved multi-component scan"
            )

        tables = _blk_tables_of(frame, scan)
        if blk_tables is None:
            blk_tables = tables
        elif blk_tables != tables:
            raise JpegUnsupportedError("pallas wavefront: mixed tables")

        # Key distinct quantizer sets by raw table bytes (cheap); the
        # int-tuple form the kernel closes over is built once per
        # distinct set, not per image (host-prep hot path).
        qkey = tuple(
            jpeg.qtables[frame.components[ci].tq].tobytes()
            for ci, _d, _a in tables
        )
        idx = qset_index.get(qkey)
        if idx is None:
            idx = len(qset_index)
            qset_index[qkey] = idx
            qset_values.append(
                tuple(
                    tuple(int(x) for x in jpeg.qtables[frame.components[ci].tq])
                    for ci, _d, _a in tables
                )
            )
        img_qset.append(idx)

        if scan.interleaved:
            total_mcus = frame.mcus_x * frame.mcus_y
        else:
            c0 = frame.components[scan.comp_indices[0]]
            total_mcus = c0.width_blocks * c0.height_blocks
        # Per-image restart intervals are fine: the kernel's lanes carry
        # their own MCU counts and predictors, and assembly slices each
        # image's lanes to its own rows-per-lane before flattening.
        ri = scan.restart_interval or total_mcus
        n_seg = -(-total_mcus // ri)
        if len(scan.rst_offsets) + 1 < n_seg:
            raise JpegTruncatedError("missing restart segments")
        if (
            scan.destuffed is not None
            and scan.dseg_starts is not None
            and len(scan.dseg_starts) >= n_seg + 1
        ):
            # parse()'s fused walk already destuffed: size rows by the
            # EXACT segment lengths (can be a 32-word bucket tighter
            # than the stuffed bound).
            ds = scan.dseg_starts
            stuffed = ds[1 : n_seg + 1] - ds[:n_seg]
        else:
            # Stuffed segment lengths bound the destuffed row size
            # (never expands), so rows can be sized without destuffing.
            ro = np.asarray(scan.rst_offsets[: n_seg - 1], dtype=np.int64)
            offs_r = np.concatenate([ro, [len(scan.data)]])
            starts_r = np.concatenate([[0], ro + 2])
            stuffed = offs_r - starts_r
        seg_rows.append((scan, n_seg))
        fm = np.arange(n_seg, dtype=np.int64) * ri
        nm = np.minimum(ri, total_mcus - fm).astype(np.int32)
        lane_meta.append(
            np.stack(
                [np.full(n_seg, img_i, np.int32), fm.astype(np.int32), nm],
                axis=1,
            )
        )
        max_words = max(
            max_words, int(stuffed.max()) // 4 + 2 if n_seg else 0
        )
        max_mcus = max(max_mcus, int(nm.max()) if n_seg else 0)

    max_words = max(max_words, min_words)
    if max_words > MAX_WORDS:
        raise JpegUnsupportedError(
            f"pallas wavefront: segment too long ({max_words} words)"
        )
    # Quantize the row width to 32-word buckets: W is the max *stuffed*
    # segment length, which jitters with image content, and W is a
    # static shape in the jitted chain — without bucketing, every chunk
    # of a stream would compile its own program.
    max_words = min(-(-max_words // 32) * 32, MAX_WORDS)

    lane_meta = np.concatenate(lane_meta, axis=0)
    L = len(lane_meta)
    W = max_words
    comp_hv = _comp_hv_of(jpegs[0].frame, jpegs[0].scans[0])
    lane_group = _pick_group(L)
    G = -(-L // lane_group)
    n_pad = G * lane_group

    # Destuff every segment straight into fixed-width byte-swapped word
    # rows — one threaded native pass per image (tj_destuff_rows).
    bits = np.empty((n_pad, W), dtype=np.int32)
    seg_bits = np.zeros(n_pad, dtype=np.int32)
    lane0 = 0
    for scan, n_seg in seg_rows:
        _fill_rows_native(
            scan, n_seg, W,
            bits[lane0 : lane0 + n_seg], seg_bits[lane0 : lane0 + n_seg],
        )
        lane0 += n_seg
    # Pad lanes: all-ones bitstream, zero MCUs (never decoded).
    bits[lane0:] = -1
    lm = np.zeros(n_pad, np.int32)
    lm[:L] = lane_meta[:, 2]

    qsets = tuple(qset_values)  # insertion-ordered: index s -> qset s
    lq = np.zeros(n_pad, np.int32)
    lq[:L] = np.asarray(img_qset, np.int32)[lane_meta[:, 0]]

    return BlockPlan(
        bits=bits,
        seg_bits=seg_bits,
        lane_m=lm,
        n_groups=G,
        n_mcus=max_mcus,
        n_words=W,
        blocks_per_mcu=len(blk_tables),
        blk_tables=blk_tables,
        comp_hv=comp_hv,
        frame_key=key0,
        lane_meta=lane_meta,
        n_lanes=L,
        images=len(jpegs),
        qsets=qsets if len(qsets) <= MAX_QSETS else (),
        img_qset=tuple(img_qset),
        lane_qset=lq,
        lane_group=lane_group,
    )


def _fill_rows_native(scan, n_seg, W, out_words, out_bits):
    """Destuff one scan's first n_seg restart segments into fixed-width
    byte-swapped word rows (native library)."""
    from ..native import entropy as native_entropy

    # The len() guard protects the C-side seg_starts[s+1] read from a
    # short cache.
    if (
        scan.destuffed is not None
        and scan.dseg_starts is not None
        and len(scan.dseg_starts) >= n_seg + 1
    ):
        # Fused-walk parse: rows are a memcpy + pad + byte-swap of the
        # already-destuffed buffer (no memchr re-walk).
        native_entropy.rows_from_dest(
            scan.destuffed, scan.dseg_starts, 0, n_seg, W,
            out_words, out_bits,
        )
    else:
        native_entropy.destuff_rows(scan, n_seg, W, out_words, out_bits)


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def _word(bits_ref, rows, w, W: int):
    """bits[row, w] per lane: one gather from the lane's word row. Reads
    past the row (reached only at stream end, where every consumer lane
    is masked) clamp to its last word."""
    return bits_ref[rows, jnp.minimum(w, W - 1)]


def _win_from_regs(w0, w1, cur):
    """32-bit window at `cur` from the register word pair (w0, w1) =
    bits[cur>>5], bits[(cur>>5)+1]."""
    hi = jax.lax.bitcast_convert_type(w0, jnp.uint32)
    lo = jax.lax.bitcast_convert_type(w1, jnp.uint32)
    sh = (cur & 31).astype(jnp.uint32)
    return (hi << sh) | jnp.where(
        sh == 0, jnp.uint32(0), lo >> (np.uint32(32) - sh)
    )


def _advance_regs(bits_ref, rows, w0, w1, cur, cur2, W: int):
    """Slide the register pair after consuming cur2-cur (<= 32) bits: at
    most one word boundary is crossed, so w0 inherits w1 on a crossing
    and only the crossing lanes load the next word."""
    crossed = (cur2 >> 5) != (cur >> 5)
    w1n = plgpu.load(
        bits_ref.at[rows, jnp.minimum((cur2 >> 5) + 1, W - 1)],
        mask=crossed, other=w1,
    )
    return jnp.where(crossed, w1, w0), w1n


def _receive_extend(win, length, size):
    """Magnitude bits follow the code inside the same window."""
    after = (win << length.astype(jnp.uint32)).astype(jnp.uint32)
    mag = jnp.where(
        size > 0,
        (after >> (np.uint32(32) - size.astype(jnp.uint32))).astype(
            jnp.int32
        ),
        0,
    )
    return jnp.where(
        (size > 0) & (mag < (1 << jnp.maximum(size - 1, 0))),
        mag - (1 << size) + 1,
        mag,
    )


def _busy_any(busy):
    """Scalar: does any lane of the program still have work."""
    return jnp.max(busy.astype(jnp.int32)) > 0


def _table_index(blk_tables) -> Tuple[List[CanonTable], List[Tuple[int, int, int]]]:
    """Distinct tables in blk_tables, and (ci, dc index, ac index) per
    block position."""
    tables: List[CanonTable] = []
    blk: List[Tuple[int, int, int]] = []
    for ci, dct, act in blk_tables:
        for t in (dct, act):
            if t not in tables:
                tables.append(t)
        blk.append((ci, tables.index(dct), tables.index(act)))
    return tables, blk


def _make_kernel(plan_static, n_comp: int, interpret: bool):
    """Build the kernel function for one static config. plan_static =
    (B, blk_tables, W, n_mcus, emit, qsets, comp_hv, lane_group):
    emit='coeff' writes zigzag coefficient blocks; emit='pixels' fuses
    dequant + islow IDCT + level-shift into the epilogue and writes each
    block as 16 int32 words of 4 raster-adjacent uint8 samples (8 rows x
    2 words; see run_wavefront for the per-component tiling).

    The block positions of an MCU run as a fori_loop over b, their
    component, tables and quantizer read from small operands, so the
    kernel holds ONE copy of the block code whatever the sampling —
    unrolled per position, a 4:2:0 kernel was six copies, and the GPU
    compiler's time grows with the copies."""
    (B, blk_tables, W, n_mcus, emit, qsets, comp_hv, lg) = plan_static

    def kernel(lane_m_ref, bits_ref, end_ref, lane_q_ref, bit0_ref,
               dc0_ref, tbl_ref, binfo_ref, qtab_ref, out_ref, err_ref,
               *scratch):
        coef_ref = scratch[0] if emit == "pixels" else None
        g = pl.program_id(0)
        sl = pl.ds(g * lg, lg)
        lane = jax.lax.broadcasted_iota(jnp.int32, (lg,), 0)
        rows = g * lg + lane
        lane_m = lane_m_ref[sl]
        lane_q = lane_q_ref[sl]
        zeros = jnp.zeros((lg,), jnp.int32)
        if emit == "pixels":
            for z in range(1, 64):
                coef_ref[z, sl] = zeros

        # bit0: starting bit within the lane's word row — zero for
        # restart segments, the sub-word offset for no-restart streams
        # split at skeleton-scan bit positions. dc0: zero for restart
        # segments (T.81 predictor reset at markers); the skeleton
        # scan's absolute predictor for no-restart lanes. Predictors are
        # kept per scan component (binfo column 0).
        cur0 = bit0_ref[sl]
        carry0 = (
            cur0,
            _word(bits_ref, rows, cur0 >> 5, W),
            _word(bits_ref, rows, (cur0 >> 5) + 1, W),
            zeros,
        ) + tuple(dc0_ref[p, sl] for p in range(n_comp))
        _barrier(interpret)

        def mcu_step(m, carry):
            active = m < lane_m

            def block_step(b, carry):
                cur, w0, w1, err = carry[:4]
                preds = carry[4:]
                pi = binfo_ref[b, 0]
                act = _load_table(tbl_ref, binfo_ref[b, 2])
                ok = active & (err == 0)

                # --- DC: one lockstep symbol for every lane. ---
                win = _win_from_regs(w0, w1, cur)
                t, dlen = _decode_symbol_win(
                    win, _load_table(tbl_ref, binfo_ref[b, 1]), tbl_ref
                )
                bad = ok & ((dlen > 16) | (t > 15))
                t = jnp.where(t > 15, 0, t)
                diff = _receive_extend(win, dlen, t)
                pred = preds[0]
                for p in range(1, n_comp):
                    pred = jnp.where(pi == p, preds[p], pred)
                pred = pred + jnp.where(ok, diff, 0)
                preds = tuple(
                    jnp.where(pi == p, pred, preds[p]) for p in range(n_comp)
                )
                dc_row = jnp.where(ok, pred, 0)
                cur2 = cur + jnp.where(ok, dlen + t, 0)
                w0, w1 = _advance_regs(bits_ref, rows, w0, w1, cur, cur2, W)
                cur = cur2
                err = jnp.where(bad, _ERR_BADCODE, err)

                if emit == "coeff":
                    out_ref[g, m, b, 0, :] = dc_row
                    for z in range(1, 64):
                        out_ref[g, m, b, z, :] = zeros
                    _barrier(interpret)

                    def put(nk, val, mask):
                        plgpu.store(
                            out_ref.at[g, m, b, nk, lane], val, mask=mask
                        )
                else:
                    # Dequantize as each coefficient lands: one gather
                    # per symbol instead of 64 per block in the epilogue.
                    def put(nk, val, mask):
                        plgpu.store(
                            coef_ref.at[nk, rows],
                            val * qtab_ref[lane_q, b, nk], mask=mask,
                        )

                # --- AC: while any lane's block is unfinished. ---
                def cond(st):
                    step, _cur, _k, _err, _w0, _w1 = st
                    return _busy_any(ok & (_k < 64) & (_err == 0)) & (step < 64)

                def body(st):
                    step, _cur, _k, _err, _w0, _w1 = st
                    busy = ok & (_k < 64) & (_err == 0)
                    awin = _win_from_regs(_w0, _w1, _cur)
                    rs, alen = _decode_symbol_win(awin, act, tbl_ref)
                    run = rs >> 4
                    size = rs & 0x0F
                    val = _receive_extend(awin, alen, size)
                    is_eob = (size == 0) & (run != 15)
                    is_zrl = (size == 0) & (run == 15)
                    nk = _k + jnp.where(size > 0, run, 0)
                    overrun = busy & (size > 0) & (nk > 63)
                    put(jnp.minimum(nk, 63), val, busy & (size > 0) & (nk <= 63))
                    nc = _cur + jnp.where(busy, alen + size, 0)
                    _w0, _w1 = _advance_regs(
                        bits_ref, rows, _w0, _w1, _cur, nc, W
                    )
                    _k = jnp.where(
                        busy,
                        jnp.where(
                            is_eob, 64, jnp.where(is_zrl, _k + 16, nk + 1)
                        ),
                        _k,
                    )
                    _err = jnp.where(busy & (alen > 16), _ERR_BADCODE, _err)
                    _err = jnp.where(overrun, _ERR_RUN, _err)
                    return step + 1, nc, _k, _err, _w0, _w1

                _, cur, _k, err, w0, w1 = jax.lax.while_loop(
                    cond, body,
                    (jnp.int32(0), cur, jnp.where(ok, 1, 64), err, w0, w1),
                )
                _barrier(interpret)
                if emit == "pixels":
                    coefs = [dc_row * qtab_ref[lane_q, b, 0]] + [
                        coef_ref[z, sl] for z in range(1, 64)
                    ]
                    for z in range(1, 64):
                        coef_ref[z, sl] = zeros
                    _barrier(interpret)
                    _idct_store(coefs, b, out_ref, g, m)
                return (cur, w0, w1, err) + preds

            return jax.lax.fori_loop(0, B, block_step, carry)

        cur, _w0, _w1, err = jax.lax.fori_loop(
            0, n_mcus, mcu_step, carry0
        )[:4]
        # Truncation: consumed beyond the segment (+7 pad bits legal).
        trunc = (cur > end_ref[sl] + 7) & (lane_m > 0)
        err_ref[sl] = err | jnp.where(trunc, _ERR_TRUNC, 0)

    return kernel


def _idct_store(coefs, b, out_ref, g, m):
    """islow IDCT (transform.idct8x8_islow's arithmetic, bit-exact) of
    block b held as 64 dequantized zigzag lane vectors; stores its 8
    rows as 2 int32 words each of 4 raster-adjacent pixels (byte 0 =
    lowest column)."""
    from .. import transform as T
    from ..bitstream import NATURAL_TO_ZIGZAG

    deq = [coefs[int(NATURAL_TO_ZIGZAG[n])] for n in range(64)]
    # Pass 1 down each column c (frequency rows i), pass 2 along each
    # output row r.
    ws = [None] * 64
    for c in range(8):
        col = T._idct_1d(
            [deq[i * 8 + c] for i in range(8)], T.CONST_BITS - T.PASS1_BITS
        )
        for r in range(8):
            ws[r * 8 + c] = col[r]
    for r in range(8):
        o = T._idct_1d(
            [ws[r * 8 + c] for c in range(8)],
            T.CONST_BITS + T.PASS1_BITS + 3,
        )
        px = [jnp.clip(v + 128, 0, 255) for v in o]
        for q in range(2):
            out_ref[g, m, b, r * 2 + q, :] = (
                px[4 * q]
                | (px[4 * q + 1] << 8)
                | (px[4 * q + 2] << 16)
                | (px[4 * q + 3] << 24)
            )


@functools.partial(jax.jit, static_argnames=("plan_static", "n_groups"))
def run_wavefront(
    bits, lane_m, seg_bits, plan_static, n_groups: int,
    lane_qset=None, bit0=None, dc0=None,
):
    """Returns (out, err). emit='coeff': out is one int32 array
    [G, M, B, 64, group]. emit='pixels': out is a TUPLE of per-scan-
    component int32 word arrays [G, v*8, M, h*2, group] (4 raster
    pixels per word). err is int32[G*group]."""
    (B, blk_tables, W, n_mcus, emit, qsets, comp_hv, lg) = plan_static
    interpret = pallas_interpret()
    n_lanes = n_groups * lg
    tables, blk_t = _table_index(blk_tables)
    comp_cis = sorted({ci for ci, _d, _a in blk_tables})
    # Per block position: (predictor slot, dc table, ac table).
    binfo = np.asarray(
        [(comp_cis.index(ci), dt, at) for ci, dt, at in blk_t], np.int32
    )
    qtab = np.asarray(qsets if emit == "pixels" else [[[0] * 64]], np.int32)
    kernel = _make_kernel(plan_static, len(comp_cis), interpret)
    if lane_qset is None:
        lane_qset = jnp.zeros((n_lanes,), jnp.int32)
    if bit0 is None:
        bit0 = jnp.zeros((n_lanes,), jnp.int32)
    if dc0 is None:
        dc0 = jnp.zeros((4, n_lanes), jnp.int32)
    dc0 = dc0[jnp.asarray(comp_cis)]

    words = 64 if emit == "coeff" else 16
    out_shapes = (
        jax.ShapeDtypeStruct((n_groups, n_mcus, B, words, lg), jnp.int32),
        jax.ShapeDtypeStruct((n_lanes,), jnp.int32),
    )
    if emit == "pixels":
        # Per-lane coefficient block the AC loop scatters into.
        out_shapes += (jax.ShapeDtypeStruct((64, n_lanes), jnp.int32),)

    res = pl.pallas_call(
        kernel,
        grid=(n_groups,),
        out_shape=out_shapes,
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=_num_warps(lg), num_stages=1
        ),
        name=f"wavefront_{emit}",
    )(lane_m, bits, seg_bits, lane_qset, bit0, dc0,
      jnp.asarray(pack_tables(tables)), jnp.asarray(binfo),
      jnp.asarray(qtab))
    out, err = res[0], res[1]
    if emit == "coeff":
        return out, err
    # [G, M, B, 8 rows x 2 words, group] -> per scan component
    # [G, v*8, M, h*2, group]: block positions run v-major then h within
    # a component (_blk_tables_of).
    comps = []
    b0 = 0
    for _ci, h, v in comp_hv:
        sub = out[:, :, b0 : b0 + v * h].reshape(
            n_groups, n_mcus, v, h, 8, 2, lg
        )
        comps.append(
            sub.transpose(0, 2, 4, 1, 3, 5, 6).reshape(
                n_groups, v * 8, n_mcus, h * 2, lg
            )
        )
        b0 += v * h
    return tuple(comps), err


# ---------------------------------------------------------------------------
# Assembly: dense kernel output -> per-component coefficient tensors
# ---------------------------------------------------------------------------


def _lanes_major(out: jnp.ndarray) -> jnp.ndarray:
    """[G, ..., group] kernel output -> [G*group, ...] lane-major."""
    nd = out.ndim
    perm = (0, nd - 1) + tuple(range(1, nd - 1))
    return out.transpose(perm).reshape(
        (out.shape[0] * out.shape[-1],) + out.shape[1:-1]
    )


def assemble(
    shape: Tuple[int, int, int], out: jnp.ndarray,
    geoms: Sequence["ImageGeom"],
) -> List[List[jnp.ndarray]]:
    """[G, M, B, 64, group] -> per image, per component [nb, 64] zigzag
    coefficient arrays (device-resident), via static transposes only.
    `shape` = (blocks_per_mcu, n_mcus, n_groups).

    Each image's lanes are sliced to that image's own MCUs-per-lane
    (its restart interval) before flattening, so images with different
    restart intervals coexist in one launch (SURVEY.md §3.5)."""
    B, M, n_groups = shape
    flat = _lanes_major(out)  # [lane, M, B, 64]

    results: List[List[jnp.ndarray]] = []
    lane0 = 0
    for scan in geoms:
        frame = scan.frame
        interleaved = scan.interleaved
        if interleaved:
            total_mcus = frame.mcus_x * frame.mcus_y
        else:
            c0 = frame.components[scan.comp_indices[0]]
            total_mcus = c0.width_blocks * c0.height_blocks
        rows = min(scan.restart_interval or total_mcus, total_mcus)
        nseg = -(-total_mcus // rows)
        lanes = flat[lane0 : lane0 + nseg, :rows]  # [nseg, rows, B, 64]
        lane0 += nseg
        # MCU-linear coefficient stream for this image.
        mcus = lanes.reshape(nseg * rows, B, 64)[:total_mcus]

        by_ci: Dict[int, jnp.ndarray] = {}
        b0 = 0
        if interleaved:
            for sp, ci in enumerate(scan.comp_indices):
                c = frame.components[ci]
                nb = c.h * c.v
                sub = mcus[:, b0 : b0 + nb]  # [mcus, v*h, 64]
                b0 += nb
                sub = sub.reshape(frame.mcus_y, frame.mcus_x, c.v, c.h, 64)
                sub = sub.transpose(0, 2, 1, 3, 4).reshape(
                    c.padded_hb * c.padded_wb, 64
                )
                by_ci[ci] = sub
            comps = [by_ci[c.index] for c in frame.components]
        else:
            ci = scan.comp_indices[0]
            c = frame.components[ci]
            grid = mcus[:, 0].reshape(c.height_blocks, c.width_blocks, 64)
            pad_r = c.padded_hb - c.height_blocks
            pad_c = c.padded_wb - c.width_blocks
            grid = jnp.pad(grid, ((0, pad_r), (0, pad_c), (0, 0)))
            comps = [grid.reshape(c.padded_hb * c.padded_wb, 64)]
        results.append(comps)
    return results


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


_COEFF_CHAIN_CACHE: "collections.OrderedDict[Tuple, object]" = (
    collections.OrderedDict()
)
_COEFF_CHAIN_MAX = 64


def _coeff_chain(plan: BlockPlan, geoms):
    """One jitted program for kernel + coefficient assembly (eagerly the
    per-image assembly transposes were a dispatch each). Keyed by static
    geometry only; closures capture ImageGeom (no bitstreams)."""
    plan_static = plan.static_key("coeff")
    shape = (plan.blocks_per_mcu, plan.n_mcus, plan.n_groups)
    key = (
        plan_static, plan.n_groups,
        tuple(
            (g.frame.height, g.frame.width,
             tuple((c.h, c.v) for c in g.frame.components),
             g.interleaved, g.comp_indices, g.restart_interval)
            for g in geoms
        ),
    )
    fn = _COEFF_CHAIN_CACHE.get(key)
    if fn is None:
        n_groups = plan.n_groups

        @jax.jit
        def fn(bits, lane_m, seg_bits):
            out, err = run_wavefront(
                bits, lane_m, seg_bits, plan_static, n_groups
            )
            return assemble(shape, out, geoms), err

        _COEFF_CHAIN_CACHE[key] = fn
        while len(_COEFF_CHAIN_CACHE) > _COEFF_CHAIN_MAX:
            _COEFF_CHAIN_CACHE.popitem(last=False)
    else:
        _COEFF_CHAIN_CACHE.move_to_end(key)
    return fn


def decode_batch_to_device(
    jpegs: Sequence[bitstream.JpegData],
    config: DecodeConfig = DEFAULT_CONFIG,
    strict: bool = True,
) -> Tuple[List[Optional[List[jnp.ndarray]]], Dict[int, Exception]]:
    """Uniform-batch device decode via the Pallas kernel. Same contract
    as wavefront.decode_batch_to_device."""
    plan = build_block_plan(jpegs)
    geoms = tuple(ImageGeom.of(j) for j in jpegs)
    fn = _coeff_chain(plan, geoms)
    assembled, err = fn(
        jnp.asarray(plan.bits),
        jnp.asarray(plan.lane_m),
        jnp.asarray(plan.seg_bits),
    )

    errs = np.asarray(err).reshape(-1)[: plan.n_lanes]
    failures = failures_from_err(errs, plan.lane_meta)
    if strict and failures:
        raise failures[min(failures)]

    results: List[Optional[List[jnp.ndarray]]] = []
    for i in range(len(jpegs)):
        results.append(None if i in failures else assembled[i])
    return results, failures


def failures_from_err(
    errs: np.ndarray, lane_meta: np.ndarray
) -> Dict[int, Exception]:
    """Map the kernel's per-lane error codes to one exception per failed
    image (first failing lane wins). `errs` must already be trimmed to
    the real lane count."""
    failures: Dict[int, Exception] = {}
    for lane in np.nonzero(errs)[0]:
        img = int(lane_meta[int(lane)][0])
        if img in failures:
            continue
        code = int(errs[lane])
        if code & _ERR_BADCODE:
            failures[img] = JpegHuffmanError(
                f"invalid Huffman code in segment {int(lane)} (image {img})"
            )
        elif code & _ERR_RUN:
            failures[img] = JpegHuffmanError(
                f"AC run past end of block in segment {int(lane)} (image {img})"
            )
        else:
            failures[img] = JpegTruncatedError(
                f"entropy segment {int(lane)} truncated (image {img})"
            )
    return failures


def decode_all_scans(
    jpeg: bitstream.JpegData, config: DecodeConfig = DEFAULT_CONFIG
) -> List[np.ndarray]:
    if jpeg.frame.progressive:
        # Device-side progressive: the four T.81 §G scan kinds run as
        # wavefront kernels over restart-segment lanes (wavefront_prog).
        from . import wavefront_prog

        acs, dcs = wavefront_prog.decode_all_scans(jpeg, config)
        out = []
        for ac, dc in zip(acs, dcs):
            arr = np.array(ac)  # writable host copy
            arr[:, 0] = np.asarray(dc)
            out.append(arr)
        return out
    if (
        not jpeg.frame.progressive
        and len(jpeg.scans) > 1
        and all(s.n_comps == 1 for s in jpeg.scans)
    ):
        # Baseline split into per-component scans (T.81 permits it):
        # decode each scan on device as its own single-component frame.
        return [
            np.asarray(c) for c in decode_multiscan_to_device(jpeg, config)
        ]
    try:
        comps, _ = decode_batch_to_device([jpeg], config, strict=True)
        return [np.asarray(c) for c in comps[0]]
    except JpegUnsupportedError:
        # Segments longer than MAX_WORDS (marker-free streams
        # or huge restart intervals): split them with the host skeleton
        # scan and decode the pieces as lanes with a DC prefix fixup.
        scan = jpeg.scans[0] if jpeg.scans else None
        if (
            scan is not None
            and not jpeg.frame.progressive
            and len(jpeg.scans) == 1
        ):
            return [
                np.asarray(c) for c in decode_norst_to_device(jpeg, config)
            ]
        raise


# ---------------------------------------------------------------------------
# Fused pixels path: wavefront + dequant + IDCT in one kernel
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ImageGeom:
    """The slice of (frame, first-scan) geometry that pixel assembly
    needs. Deliberately free of the entropy payload so jitted chains can
    close over it without pinning whole bitstreams in the chain cache."""

    frame: bitstream.Frame
    interleaved: bool
    comp_indices: Tuple[int, ...]
    restart_interval: int

    @classmethod
    def of(cls, jpeg: bitstream.JpegData) -> "ImageGeom":
        s = jpeg.scans[0]
        return cls(
            jpeg.frame, s.interleaved, tuple(s.comp_indices),
            s.restart_interval,
        )


def _words_to_plane(a: jnp.ndarray) -> jnp.ndarray:
    """[..., W4] int32 raster words -> [..., W4*4] uint8 raster (free
    little-endian bitcast: byte 0 of each word is its lowest column)."""
    u = jax.lax.bitcast_convert_type(a, jnp.uint8)
    return u.reshape(*a.shape[:-1], a.shape[-1] * 4)


def _raster_words(
    lanes: jnp.ndarray, mcus_y: int, mcus_x: int, rows: int,
    total_mcus: int, pad_hb8: int, pad_w2: int
) -> jnp.ndarray:
    """One image's, one component's lane tiles [nseg, v8, M, w2] ->
    raster word grid [pad_hb8, pad_w2] int32 (leading batch dims pass
    through). `rows` = MCUs actually covered per lane (<= M).

    Fast path: when every lane covers `rows` consecutive MCUs of ONE
    MCU row (rows divides mcus_x), the raster transpose's minor run is
    the whole (M, w2) tile — 64+ byte granules. Otherwise MCU-linear."""
    lead = lanes.shape[:-4]
    nseg, v8, M, w2 = lanes.shape[-4:]
    lanes = lanes[..., :rows, :]
    if mcus_x % rows == 0 and nseg * rows >= mcus_y * mcus_x:
        sx = mcus_x // rows
        a = lanes.reshape(*lead, mcus_y, sx, v8, rows, w2)
        nd = len(lead)
        perm = tuple(range(nd)) + tuple(
            nd + i for i in (0, 2, 1, 3, 4)
        )
        a = a.transpose(*perm).reshape(
            *lead, mcus_y * v8, sx * rows * w2
        )
    else:
        nd = len(lead)
        # MCU-linear: (nseg, rows) merge needs v8 moved out from
        # between them first.
        perm = tuple(range(nd)) + tuple(nd + i for i in (0, 2, 1, 3))
        a = lanes.transpose(*perm).reshape(*lead, nseg * rows, v8, w2)[
            ..., :total_mcus, :, :
        ]
        a = a.reshape(*lead, mcus_y, mcus_x, v8, w2)
        a = a.transpose(*perm).reshape(
            *lead, mcus_y * v8, mcus_x * w2
        )
    pr = pad_hb8 - a.shape[-2]
    pc = pad_w2 - a.shape[-1]
    if pr or pc:
        a = jnp.pad(
            a, ((0, 0),) * len(lead) + ((0, pr), (0, pc))
        )
    return a


def assemble_pixels(
    shape: Tuple[int, int, int],
    out: Sequence[jnp.ndarray],
    geoms: Sequence[ImageGeom],
) -> List[List[jnp.ndarray]]:
    """Per-scan-component kernel outputs [G, v8, M, w2, group] int32
    (4 raster-adjacent pixels per word, MCU tiles packed in-register by
    the kernel epilogue) -> per image, per component sample planes
    [padded_h, padded_w] uint8 (device-resident). Every transpose moves
    int32 elements whose bytes are already in raster order, so no
    byte-granular shuffle ever runs and the final u8 view is a bitcast.
    `shape` = (blocks_per_mcu, n_mcus, n_groups). Per-image restart
    intervals are honored by slicing each image's lanes to its own
    MCUs-per-lane before flattening."""
    B, M, G = shape
    comps_lanes = [_lanes_major(arr) for arr in out]

    results: List[List[jnp.ndarray]] = []
    lane0 = 0
    for geom in geoms:
        frame = geom.frame
        scan = geom
        if scan.interleaved:
            total_mcus = frame.mcus_x * frame.mcus_y
            mcus_y, mcus_x = frame.mcus_y, frame.mcus_x
        else:
            c0 = frame.components[scan.comp_indices[0]]
            total_mcus = c0.width_blocks * c0.height_blocks
            mcus_y, mcus_x = c0.height_blocks, c0.width_blocks
        rows = min(scan.restart_interval or total_mcus, total_mcus)
        nseg = -(-total_mcus // rows)

        by_ci: Dict[int, jnp.ndarray] = {}
        for sp, ci in enumerate(
            scan.comp_indices if scan.interleaved else scan.comp_indices[:1]
        ):
            c = frame.components[ci]
            sub = comps_lanes[sp][lane0 : lane0 + nseg]
            grid = _raster_words(
                sub, mcus_y, mcus_x, rows, total_mcus,
                c.padded_hb * 8, c.padded_wb * 2,
            )
            by_ci[ci] = _words_to_plane(grid)
        lane0 += nseg
        if scan.interleaved:
            planes = [by_ci[c.index] for c in frame.components]
        else:
            planes = [by_ci[scan.comp_indices[0]]]
        results.append(planes)
    return results


def assemble_pixels_stacked(
    shape: Tuple[int, int, int],
    out: jnp.ndarray,
    geoms: Sequence[ImageGeom],
) -> List[jnp.ndarray]:
    """assemble_pixels + stack-over-images in one shot: per component, a
    [n_images, padded_h, padded_w] uint8 plane batch (what
    transform_planes_batch consumes).

    When every image shares one geometry AND one restart interval (the
    steady state of batched streams), the image axis stays a leading dim
    through a SINGLE raster transpose per component: XLA materializes
    one copy instead of one slice+transpose per image feeding a
    concatenate. Mixed restart intervals fall back to the per-image
    path + stack."""
    B, M, G = shape
    g0 = geoms[0]
    frame = g0.frame
    aligned = all(
        g.frame is frame or (
            g.frame.height == frame.height
            and g.frame.width == frame.width
            and g.interleaved == g0.interleaved
            and g.comp_indices == g0.comp_indices
            and g.restart_interval == g0.restart_interval
        )
        for g in geoms[1:]
    )
    if not aligned:
        per = assemble_pixels(shape, out, geoms)
        return [
            jnp.stack([per[i][ci] for i in range(len(geoms))])
            for ci in range(frame.n_components)
        ]

    n = len(geoms)
    if g0.interleaved:
        total_mcus = frame.mcus_x * frame.mcus_y
        mcus_y, mcus_x = frame.mcus_y, frame.mcus_x
    else:
        c0 = frame.components[g0.comp_indices[0]]
        total_mcus = c0.width_blocks * c0.height_blocks
        mcus_y, mcus_x = c0.height_blocks, c0.width_blocks
    rows = min(g0.restart_interval or total_mcus, total_mcus)
    nseg = -(-total_mcus // rows)

    # Same clean 2-D int32 lane transpose as assemble_pixels; the
    # per-image slicing becomes one reshape since every image owns
    # exactly `nseg` consecutive lanes.
    stacked: List[jnp.ndarray] = []
    by_ci: Dict[int, jnp.ndarray] = {}
    comp_cis = g0.comp_indices if g0.interleaved else g0.comp_indices[:1]
    for sp, ci in enumerate(comp_cis):
        c = frame.components[ci]
        lanes = _lanes_major(out[sp])[: n * nseg]
        v8, w2 = lanes.shape[1], lanes.shape[3]
        lanes = lanes.reshape(n, nseg, v8, M, w2)
        grid = _raster_words(
            lanes, mcus_y, mcus_x, rows, total_mcus,
            c.padded_hb * 8, c.padded_wb * 2,
        )
        by_ci[ci] = _words_to_plane(grid)
    if g0.interleaved:
        stacked = [by_ci[c.index] for c in frame.components]
    else:
        stacked = [by_ci[g0.comp_indices[0]]]
    return stacked


# Cache of jitted end-to-end chains (kernel + assembly + color) keyed by
# every shape/static-relevant property: compiling the WHOLE chain as one
# XLA program lets the assembly transposes fuse with the kernels' pads
# and crops. The cached
# closures capture only static geometry (ImageGeom), never bitstreams,
# and the cache is LRU-bounded so pathological shape churn can't grow it
# without limit.
_CHAIN_CACHE: "collections.OrderedDict[Tuple, object]" = collections.OrderedDict()
_CHAIN_CACHE_MAX = 64


def _rgb_chain(plan: BlockPlan, jpegs, config, packed: bool = False):
    """packed: emit the column-packed planar uint16 layout (bytes = the
    planar u8 raster; see pipeline.packed_layout_applies).

    No-restart plans (plan.bit0 set — lanes split at skeleton-scan bit
    offsets with DC-primed predictors) run the SAME fused chain; the
    jitted fn then takes two extra args (bit0, dc0) and assembly treats
    `norst_every` MCUs per lane as the effective restart interval."""
    from . import pipeline as kernel_pipeline

    norst = plan.bit0 is not None
    if norst:
        geoms = tuple(
            dataclasses.replace(
                ImageGeom.of(j), restart_interval=plan.norst_every
            )
            for j in jpegs
        )
    else:
        geoms = tuple(ImageGeom.of(j) for j in jpegs)
    frame = geoms[0].frame
    color = bitstream.color_space(jpegs[0])
    shape = (plan.blocks_per_mcu, plan.n_mcus, plan.n_groups)
    n_images = len(jpegs)
    packed = packed and kernel_pipeline.packed_layout_applies(
        frame, config, color
    )
    plan_static = plan.static_key("pixels")
    key = (
        plan_static, plan.n_groups, plan.frame_key, n_images,
        # Per-image scan geometry: lane counts alone can collide for
        # different restart intervals (ceil(T/ri) is not injective).
        tuple(
            (g.interleaved, g.comp_indices, g.restart_interval)
            for g in geoms
        ),
        plan.img_qset, norst,
        config.fancy_upsampling, color, packed,
    )
    fn = _CHAIN_CACHE.get(key)
    if fn is None:
        n_groups = plan.n_groups

        def run(bits, lane_m, seg_bits, lane_qset, bit0=None, dc0=None):
            out, err = run_wavefront(
                bits, lane_m, seg_bits, plan_static, n_groups,
                lane_qset, bit0=bit0, dc0=dc0,
            )
            stacked = assemble_pixels_stacked(shape, out, geoms)
            rgb = kernel_pipeline.transform_planes_batch(
                frame, stacked, config, color=color, packed=packed
            )
            return rgb, err

        fn = jax.jit(run)
        _CHAIN_CACHE[key] = fn
        while len(_CHAIN_CACHE) > _CHAIN_CACHE_MAX:
            _CHAIN_CACHE.popitem(last=False)
    else:
        _CHAIN_CACHE.move_to_end(key)
    return fn


def decode_batch_to_rgb(
    jpegs: Sequence[bitstream.JpegData],
    config: DecodeConfig = DEFAULT_CONFIG,
    defer_errors: bool = False,
) -> Tuple[Optional[jnp.ndarray], object]:
    """Fully fused on-device decode: ONE XLA program runs the wavefront+
    IDCT kernel, pixel assembly and the upsample/color stage — RGB in
    HBM, coefficients never materialized. Returns ([N, H, W, 3] or
    [N, H, W] device array, failures). With defer_errors the second
    element is the opaque (err, plan) pair for resolve_rgb_errors —
    nothing is read back, so a caller can dispatch several buckets'
    chains and the device overlaps them instead of serializing on
    per-bucket error syncs."""
    plan = build_block_plan(jpegs)
    if not plan.qsets:
        raise JpegUnsupportedError(
            f"fused pixels mode takes at most {MAX_QSETS} distinct "
            "quantizer sets per batch"
        )
    fn = _rgb_chain(plan, jpegs, config)
    rgb, err = fn(
        jnp.asarray(plan.bits),
        jnp.asarray(plan.lane_m),
        jnp.asarray(plan.seg_bits),
        jnp.asarray(plan.lane_qset),
    )
    if defer_errors:
        return rgb, (err, plan)
    return rgb, resolve_rgb_errors(err, plan)


def resolve_rgb_errors(err, plan: "BlockPlan") -> Dict[int, Exception]:
    """Force a deferred decode_batch_to_rgb error vector (the chain's
    first readback) and map it to per-image failures."""
    errs = np.asarray(err).reshape(-1)[: plan.n_lanes]
    return failures_from_err(errs, plan.lane_meta)


# ---------------------------------------------------------------------------
# No-restart streams on device (SURVEY.md §5 long-context item 3/4;
# BASELINE.json:5 "DC-predictor state via collectives")
#
# A marker-free baseline scan is one serial Huffman chain. A fast host
# skeleton scan (native tj_scan_split: symbol lengths only, no stores)
# records the bit offset of every k-th MCU; the kernel then decodes
# those segments as ordinary wavefront lanes starting at arbitrary bit
# offsets with LOCAL DC predictors (starting at 0), and the true DCs are
# recovered afterwards by an exclusive prefix sum of per-lane DC totals
# — on one device as a jnp.cumsum, across shards via
# halo.dc_prefix_fixup.
# ---------------------------------------------------------------------------


def _skeleton_walk_py(dest: bytes, jpeg, scan, total: int, every: int):
    """Pure-python skeleton walk over one destuffed (sub-)buffer.
    Returns (offs_i64, dcs_i32): bit offsets of every `every`-th MCU plus
    the total, and the DC predictor value per scan component at each of
    those points (the per-lane priming for the fused pixels kernel)."""
    from .. import huffman as hf

    tbls = hf.build_tables(scan.huff)
    frame = jpeg.frame
    if scan.interleaved:
        sps: List[int] = []
        for p, ci in enumerate(scan.comp_indices):
            c = frame.components[ci]
            sps += [p] * (c.h * c.v)
    else:
        sps = [0]
    dcts = [tbls[(0, scan.dc_ids[p])] for p in range(scan.n_comps)]
    acs = [tbls[(1, scan.ac_ids[p])] for p in range(scan.n_comps)]
    r = hf.BitReader(bytes(dest))
    offs = []
    dcs = []
    pred = [0] * scan.n_comps
    for m in range(total):
        if m % every == 0:
            offs.append(r.pos * 8 + r.pad_bits - r.cnt)
            dcs.append(list(pred))
        for sp in sps:
            t = hf.decode_symbol(r, dcts[sp])
            if t > 15:
                raise JpegHuffmanError("bad DC size")
            pred[sp] += hf.extend(r.receive(t), t)
            k = 1
            while k < 64:
                rs = hf.decode_symbol(r, acs[sp])
                run, size = rs >> 4, rs & 15
                if size == 0:
                    if run == 15:
                        k += 16
                        continue
                    break
                k += run
                if k > 63:
                    raise JpegHuffmanError("AC run past end of block")
                r.receive(size)
                k += 1
    offs.append(r.pos * 8 + r.pad_bits - r.cnt)
    dcs.append(list(pred))
    if r.overrun():
        raise JpegTruncatedError("entropy stream truncated")
    return (
        np.asarray(offs, np.int64),
        np.asarray(dcs, np.int32).reshape(len(offs), scan.n_comps),
    )


def _scan_split_host(jpeg, scan, every: int):
    """Skeleton scan of EVERY restart segment (or of the single
    marker-free stream), native with a pure-python fallback. Returns
    (destuffed uint8 array, int64 ABSOLUTE bit offsets [n_lanes+1],
    first-lane index of each marker segment, int32 per-lane DC
    predictors [n_lanes, n_scan_comps] — the value of each scan
    component's predictor at the lane's first MCU, resetting to zero at
    marker boundaries per T.81). Lane boundaries fall at every `every`
    MCUs within a marker segment and always at marker boundaries (the
    caller picks `every` dividing the DRI)."""
    from ..errors import JpegError as _JE

    frame = jpeg.frame
    if scan.interleaved:
        total = frame.mcus_x * frame.mcus_y
    else:
        c0 = frame.components[scan.comp_indices[0]]
        total = c0.width_blocks * c0.height_blocks
    ri = scan.restart_interval or total

    native = None
    try:
        from ..native import entropy as ne

        ne.destuff_rows  # force the lazy build; failures fall through
        native = ne
    except _JE:
        raise
    except Exception:
        native = None

    if native is not None:
        dest, seg_starts = native.destuff_segments(scan)
    else:
        pieces = bitstream.split_restart_segments(scan)
        seg_starts = np.zeros(len(pieces) + 1, np.int64)
        np.cumsum([len(p) for p in pieces], out=seg_starts[1:])
        dest = np.frombuffer(b"".join(bytes(p) for p in pieces), np.uint8)

    offs_all = []
    dcs_all = []
    seg_first = []
    lane0 = 0
    mcu = 0
    si = 0
    while mcu < total:
        n_m = min(ri, total - mcu)
        s0 = int(seg_starts[si])
        s1 = int(seg_starts[si + 1])
        sub = dest[s0:s1]
        if native is not None:
            offs, dcs = native.scan_split_buf(sub, jpeg, scan, n_m, every)
        else:
            offs, dcs = _skeleton_walk_py(
                bytes(sub), jpeg, scan, n_m, every
            )
        seg_first.append(lane0)
        lane0 += len(offs) - 1
        offs_all.append(offs[:-1] + s0 * 8)
        dcs_all.append(dcs[:-1])
        last_end = offs[-1] + s0 * 8
        mcu += n_m
        si += 1
    offs_flat = np.concatenate(offs_all + [[last_end]])
    dcs_flat = np.concatenate(dcs_all)
    return dest, offs_flat, np.asarray(seg_first, np.int64), dcs_flat


def build_norst_plan(
    jpeg: bitstream.JpegData, every: int = 0
) -> BlockPlan:
    """Plan a baseline scan as wavefront lanes split at skeleton-scan
    bit offsets — for marker-FREE streams (the whole scan is one serial
    chain) and for restart-segmented streams whose segments exceed
    MAX_WORDS (huge DRIs). `every` is snapped to a divisor of the
    restart interval so every lane covers exactly `every` MCUs (only the
    stream's final lane is short), keeping assembly reshape-only. Lanes
    start mid-word (plan.bit0) with predictors PRIMED to the skeleton
    scan's absolute DC values (plan.lane_dc0, resetting at marker
    boundaries per T.81) — the kernel emits true DCs directly, so both
    coeff and fused-pixels emit work with no post-hoc prefix fixup.
    (decode_norst_sharded instead keeps local predictors + the
    dc_prefix_fixup collective, ignoring lane_dc0.)"""
    frame = jpeg.frame
    if frame.progressive:
        raise JpegUnsupportedError("pallas wavefront: baseline only")
    if len(jpeg.scans) != 1:
        raise JpegUnsupportedError("pallas wavefront: one scan only")
    scan = jpeg.scans[0]
    if not scan.interleaved and frame.n_components != 1:
        raise JpegUnsupportedError(
            "pallas wavefront: non-interleaved multi-component scan"
        )

    if scan.interleaved:
        total_mcus = frame.mcus_x * frame.mcus_y
    else:
        c0 = frame.components[scan.comp_indices[0]]
        total_mcus = c0.width_blocks * c0.height_blocks
    if total_mcus <= 0:
        raise JpegUnsupportedError("empty scan")
    ri = scan.restart_interval or total_mcus

    def snap_divisor(e: int) -> int:
        e = max(1, min(e, ri))
        while ri % e:
            e -= 1
        return e

    avg_bits = max(1, len(scan.data) * 8 // total_mcus)
    if every <= 0:
        # Target roughly half of MAX_WORDS per lane so content skew has
        # headroom; clamp so tiny images still split into >= 2 lanes.
        every = max(1, (MAX_WORDS * 32 // 2) // avg_bits)
    every = snap_divisor(every)

    dest = offs = seg_first = dcs = None
    W = MAX_WORDS + 1
    for _ in range(6):
        dest, offs, seg_first, dcs = _scan_split_host(jpeg, scan, every)
        start_words = (offs[:-1] >> 5).astype(np.int64)
        end_rel = offs[1:] - (start_words << 5)
        W = int(-(-int(end_rel.max()) // 32)) + 1
        W = min(-(-W // 32) * 32, MAX_WORDS + 32)
        if W <= MAX_WORDS or every == 1:
            break
        every = snap_divisor(every // 2)
    if W > MAX_WORDS:
        raise JpegUnsupportedError(
            "skeleton split: a sub-segment exceeds MAX_WORDS"
        )

    L = len(offs) - 1
    lane_group = _pick_group(L)
    G = -(-L // lane_group)
    n_pad = G * lane_group

    start_byte = (start_words * 4).astype(np.int64)
    # Row l is dest[start_byte[l] : +W*4], 0xFF past the stream end: a
    # sliding-window VIEW + one row gather. (The obvious [L, W*4] index
    # matrix materializes L*W*4 int64s — half a GB at 32K lanes — and
    # was the no-restart host-prep bottleneck once the skeleton scan
    # went parallel.)
    row_bytes = W * 4
    dest_pad = np.concatenate(
        [dest, np.full(row_bytes + 8, 0xFF, np.uint8)]
    )
    windows = np.lib.stride_tricks.sliding_window_view(dest_pad, row_bytes)
    rows_full = np.full((n_pad, row_bytes), 0xFF, np.uint8)
    rows_full[:L] = windows[start_byte]
    bits = (
        np.ascontiguousarray(rows_full)
        .view(">u4")
        .astype(np.uint32)
        .view(np.int32)
        .reshape(n_pad, W)
    )

    seg_bits = np.zeros(n_pad, np.int32)
    seg_bits[:L] = end_rel.astype(np.int32)
    bit0 = np.zeros(n_pad, np.int32)
    bit0[:L] = (offs[:-1] - (start_words << 5)).astype(np.int32)
    # Per-lane DC predictor priming, spread from scan-component order to
    # the kernel's per-component-index rows.
    lane_dc0 = np.zeros((4, n_pad), np.int32)
    prime_cis = (
        scan.comp_indices if scan.interleaved else scan.comp_indices[:1]
    )
    for p, ci in enumerate(prime_cis):
        lane_dc0[ci, :L] = dcs[:, p]

    fm = np.arange(L, dtype=np.int64) * every
    nm = np.minimum(every, total_mcus - fm).astype(np.int32)
    lane_meta = np.stack(
        [np.zeros(L, np.int32), fm.astype(np.int32), nm], axis=1
    )
    lm = np.zeros(n_pad, np.int32)
    lm[:L] = nm

    tables = _blk_tables_of(frame, scan)
    q_t = tuple(
        tuple(int(x) for x in jpeg.qtables[frame.components[ci].tq])
        for ci, _d, _a in tables
    )

    return BlockPlan(
        bits=bits,
        seg_bits=seg_bits,
        lane_m=lm,
        n_groups=G,
        n_mcus=int(nm.max()),
        n_words=W,
        blocks_per_mcu=len(tables),
        blk_tables=tables,
        comp_hv=_comp_hv_of(frame, scan),
        frame_key=(
            frame.height, frame.width,
            tuple((c.h, c.v) for c in frame.components),
        ),
        lane_meta=lane_meta,
        n_lanes=L,
        images=1,
        qsets=(q_t,),
        img_qset=(0,),
        lane_qset=np.zeros(n_pad, np.int32),
        bit0=bit0,
        lane_dc0=lane_dc0,
        norst_every=every,
        lane_seg=(fm // ri).astype(np.int64),
        seg_first=seg_first,
        lane_group=lane_group,
    )


def _norst_geom(jpeg) -> Tuple:
    """Light static geometry for _norst_assemble_g / the jitted norst
    chain (no JpegData references pinned in closures or cache keys)."""
    frame = jpeg.frame
    scan = jpeg.scans[0]
    return (
        scan.interleaved, tuple(scan.comp_indices),
        frame.mcus_x, frame.mcus_y,
        tuple(
            (c.h, c.v, c.padded_hb, c.padded_wb, c.height_blocks,
             c.width_blocks)
            for c in frame.components
        ),
    )


def _norst_assemble_g(geom: Tuple, B: int, rows: int, M: int, flat):
    """MCU-linear assembly of the fixed-up [L, M, B, 64] lanes into
    per-component [padded_blocks, 64] zigzag grids (single image)."""
    interleaved, comp_indices, mcus_x, mcus_y, comps = geom
    if interleaved:
        total_mcus = mcus_x * mcus_y
    else:
        _h, _v, _phb, _pwb, hb, wb = comps[comp_indices[0]]
        total_mcus = wb * hb
    mcus = flat[:, : min(rows, M)].reshape(-1, B, 64)[:total_mcus]

    if interleaved:
        by_ci: Dict[int, jnp.ndarray] = {}
        b0 = 0
        for sp, ci in enumerate(comp_indices):
            h, v, phb, pwb, _hb, _wb = comps[ci]
            nb = h * v
            sub = mcus[:, b0 : b0 + nb]
            b0 += nb
            sub = sub.reshape(mcus_y, mcus_x, v, h, 64)
            sub = sub.transpose(0, 2, 1, 3, 4).reshape(phb * pwb, 64)
            by_ci[ci] = sub
        return [by_ci[ci] for ci in range(len(comps))]
    ci = comp_indices[0]
    _h, _v, phb, pwb, hb, wb = comps[ci]
    grid = mcus[:, 0].reshape(hb, wb, 64)
    grid = jnp.pad(grid, ((0, phb - hb), (0, pwb - wb), (0, 0)))
    return [grid.reshape(phb * pwb, 64)]


def _norst_assemble(plan: BlockPlan, flat, jpeg) -> List[jnp.ndarray]:
    return _norst_assemble_g(
        _norst_geom(jpeg), plan.blocks_per_mcu, plan.norst_every,
        plan.n_mcus, flat,
    )


_NORST_CHAIN_CACHE: "collections.OrderedDict[Tuple, object]" = (
    collections.OrderedDict()
)
_NORST_CHAIN_MAX = 32


def _norst_chain(plan: BlockPlan, jpeg):
    """One jitted program for the whole no-restart device path: the
    wavefront kernel + lane transpose + assembly (eagerly a dozen
    dispatched ops per decode). Keyed by geometry only."""
    geom = _norst_geom(jpeg)
    key = (
        geom, plan.n_groups, plan.n_mcus, plan.n_words,
        plan.blocks_per_mcu, plan.blk_tables, plan.n_lanes,
        plan.norst_every, len(plan.seg_first), plan.lane_group,
    )
    fn = _NORST_CHAIN_CACHE.get(key)
    if fn is not None:
        _NORST_CHAIN_CACHE.move_to_end(key)
        return fn

    G, M, W = plan.n_groups, plan.n_mcus, plan.n_words
    B = plan.blocks_per_mcu
    n_lanes, rows = plan.n_lanes, plan.norst_every
    plan_static = plan.static_key("coeff")

    def run(bits, lane_m, seg_bits, bit0, dc0):
        # dc0 primes each lane's predictors with the skeleton scan's
        # absolute values: the kernel writes TRUE DCs directly, no
        # post-hoc prefix fixup pass.
        out, err = run_wavefront(
            bits, lane_m, seg_bits, plan_static, G, bit0=bit0, dc0=dc0,
        )
        flat = _lanes_major(out)[:n_lanes]
        return _norst_assemble_g(geom, B, rows, M, flat), err

    fn = jax.jit(run)
    _NORST_CHAIN_CACHE[key] = fn
    while len(_NORST_CHAIN_CACHE) > _NORST_CHAIN_MAX:
        _NORST_CHAIN_CACHE.popitem(last=False)
    return fn


def decode_norst_to_device(
    jpeg: bitstream.JpegData,
    config: DecodeConfig = DEFAULT_CONFIG,
    every: int = 0,
) -> List[jnp.ndarray]:
    """Device entropy decode of a no-restart baseline scan: skeleton
    scan -> lanes at bit offsets with DC-primed predictors -> wavefront
    kernel -> assembled coefficient grids (device-resident). Raises on
    data errors (strict)."""
    plan = build_norst_plan(jpeg, every)
    fn = _norst_chain(plan, jpeg)
    coeffs, err = fn(
        jnp.asarray(plan.bits), jnp.asarray(plan.lane_m),
        jnp.asarray(plan.seg_bits), jnp.asarray(plan.bit0),
        jnp.asarray(plan.lane_dc0),
    )
    errs = np.asarray(err).reshape(-1)[: plan.n_lanes]
    failures = failures_from_err(errs, plan.lane_meta)
    if failures:
        raise failures[min(failures)]
    return coeffs


def decode_multiscan_to_device(
    jpeg: bitstream.JpegData, config: DecodeConfig = DEFAULT_CONFIG
) -> List[jnp.ndarray]:
    """Baseline image split into per-component non-interleaved scans
    (T.81 §B.2.3 permits any scan partition; VERDICT r4 missing #5):
    each scan decodes ON DEVICE as its own single-component frame — the
    non-interleaved scan of component ci is bit-identical to a
    grayscale scan over ci's (dwidth, dheight) sample grid — and the
    block grid pads back into the true frame's MCU-padded geometry.
    Oversize/marker-free scans take the skeleton-split lanes like any
    other stream. Returns per-component [padded_blocks, 64] zigzag
    coefficient arrays (device-resident)."""
    frame = jpeg.frame
    out: List[jnp.ndarray] = []
    grids: Dict[int, jnp.ndarray] = {}
    for scan in jpeg.scans:
        if scan.n_comps != 1:
            raise JpegUnsupportedError(
                "pallas wavefront: interleaved sub-scan in multi-scan file"
            )
        ci = scan.comp_indices[0]
        c = frame.components[ci]
        subframe = bitstream.Frame(
            progressive=False,
            precision=frame.precision,
            height=c.dheight,
            width=c.dwidth,
            components=[
                bitstream.Component(index=0, cid=c.cid, h=1, v=1, tq=c.tq)
            ],
        )
        subframe.finalize()
        subscan = dataclasses.replace(scan, comp_indices=[0])
        sub = bitstream.JpegData(
            frame=subframe,
            scans=[subscan],
            qtables=jpeg.qtables,
            restart_interval=scan.restart_interval,
        )
        try:
            comps, _ = decode_batch_to_device([sub], config, strict=True)
            grid = comps[0][0]
        except JpegUnsupportedError:
            grid = decode_norst_to_device(sub, config)[0]
        sc = subframe.components[0]
        grid = grid.reshape(sc.padded_hb, sc.padded_wb, 64)
        grid = jnp.pad(
            grid,
            (
                (0, c.padded_hb - sc.padded_hb),
                (0, c.padded_wb - sc.padded_wb),
                (0, 0),
            ),
        )
        grids[ci] = grid.reshape(-1, 64)
    for ci, c in enumerate(frame.components):
        if ci not in grids:
            raise JpegTruncatedError(
                f"multi-scan file has no scan for component {ci}"
            )
        out.append(grids[ci])
    return out


def decode_norst_to_rgb(
    jpeg: bitstream.JpegData,
    config: DecodeConfig = DEFAULT_CONFIG,
    every: int = 0,
    packed: bool = False,
):
    """FUSED decode of a no-restart (or oversize-DRI) baseline scan:
    skeleton-split lanes with DC-PRIMED predictors run the same
    wavefront+IDCT+upsample+color chain as restart-segmented streams —
    marker-free images get the full speed-of-light pixels path instead
    of dropping to coeff mode + separate transform. Returns a
    device-resident [H, W, 3]/[H, W] raster (or, with packed=True on an
    applicable layout, the planar column-packed uint16 [3, H, W//2]
    whose bytes are the u8 raster). Raises on data errors (strict)."""
    plan = build_norst_plan(jpeg, every)
    if not plan.qsets:
        raise JpegUnsupportedError("too many quantizer sets")
    fn = _rgb_chain(plan, [jpeg], config, packed=packed)
    rgb, err = fn(
        jnp.asarray(plan.bits),
        jnp.asarray(plan.lane_m),
        jnp.asarray(plan.seg_bits),
        jnp.asarray(plan.lane_qset),
        jnp.asarray(plan.bit0),
        jnp.asarray(plan.lane_dc0),
    )
    errs = np.asarray(err).reshape(-1)[: plan.n_lanes]
    failures = failures_from_err(errs, plan.lane_meta)
    if failures:
        raise failures[min(failures)]
    return rgb[0]


def decode_norst_sharded(
    jpeg: bitstream.JpegData,
    config: DecodeConfig = DEFAULT_CONFIG,
    every: int = 0,
    axis: str = "lanes",
    mesh=None,
) -> List[jnp.ndarray]:
    """No-restart entropy decode SHARDED over the device mesh: each
    device wavefront-decodes a contiguous chunk of skeleton-scan lanes
    with local predictors; the cross-shard DC base travels between
    devices via halo.dc_prefix_fixup (BASELINE.json:5 "DC-predictor
    state via collectives"), and a local exclusive prefix finishes the
    fixup.
    Returns device-resident per-component coefficient grids."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..parallel import halo

    if mesh is None:
        mesh = jax.make_mesh((jax.device_count(),), (axis,))
    d = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if jpeg.scans and len(jpeg.scans[0].rst_offsets):
        # The cross-shard base collective assumes one continuous
        # predictor chain; restart-segmented oversize streams use the
        # single-device segmented path instead.
        raise JpegUnsupportedError(
            "sharded skeleton decode: marker-free streams only"
        )
    plan = build_norst_plan(jpeg, every)

    # Pad the program axis to a multiple of the mesh: padding programs
    # hold zero-MCU lanes that decode nothing and contribute zero DC
    # totals.
    G = plan.n_groups
    Gp = -(-G // d) * d
    lg = plan.lane_group

    def gpad(a, fill=0):
        out = np.full((Gp * lg,) + a.shape[1:], fill, a.dtype)
        out[: G * lg] = a
        return out

    bits = gpad(plan.bits, -1)
    lane_m = gpad(plan.lane_m)
    seg_bits = gpad(plan.seg_bits)
    bit0 = gpad(plan.bit0)
    gd = Gp // d  # groups per device
    M, B = plan.n_mcus, plan.blocks_per_mcu
    plan_static = plan.static_key("coeff")
    blk_tables = plan.blk_tables
    cis = sorted({ci for ci, _d2, _a in blk_tables})
    last_b = {ci: max(b for b, t in enumerate(blk_tables) if t[0] == ci)
              for ci in cis}

    def local(bits_l, lane_m_l, seg_bits_l, bit0_l):
        out, err = run_wavefront(
            bits_l, lane_m_l, seg_bits_l, plan_static, gd, bit0=bit0_l,
        )
        flat = _lanes_major(out)
        lm = lane_m_l
        dc = flat[..., 0]
        last_mcu = jnp.maximum(lm - 1, 0)
        # Per-shard DC-delta totals per component -> the collective.
        local_tots = []
        off_local = {}
        for ci in cis:
            tot = jnp.take_along_axis(
                dc[:, :, last_b[ci]], last_mcu[:, None], axis=1
            )[:, 0]
            tot = jnp.where(lm > 0, tot, 0)
            off_local[ci] = jnp.cumsum(tot) - tot
            local_tots.append(jnp.sum(tot))
        base = halo.dc_prefix_fixup(
            jnp.stack(local_tots).astype(jnp.int32), axis
        )  # [C]: sum of every previous shard's totals
        add_b = jnp.stack(
            [
                off_local[blk_tables[b][0]]
                + base[cis.index(blk_tables[b][0])]
                for b in range(B)
            ],
            axis=-1,
        )  # [Ld, B]
        flat = flat.at[..., 0].add(
            jnp.where((lm > 0)[:, None], add_b, 0)[:, None, :]
        )
        return flat, err

    fn = jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )
    )
    flat, err = fn(
        jnp.asarray(bits), jnp.asarray(lane_m), jnp.asarray(seg_bits),
        jnp.asarray(bit0),
    )
    errs = np.asarray(err).reshape(-1)[: plan.n_lanes]
    failures = failures_from_err(errs, plan.lane_meta)
    if failures:
        raise failures[min(failures)]
    # Assembly slices at lane granularity (not shard-aligned): gather the
    # corrected lanes first. The downstream transform reshards by MCU
    # rows anyway (halo.decode_sharded), so this is the natural exchange
    # point between lane sharding and row sharding.
    from jax.sharding import NamedSharding

    flat = jax.device_put(flat, NamedSharding(mesh, P()))
    return _norst_assemble(plan, flat[: plan.n_lanes], jpeg)


def decode_batch_to_rgb_sharded(
    jpegs: Sequence[bitstream.JpegData],
    config: DecodeConfig = DEFAULT_CONFIG,
    axis: str = "data",
    mesh=None,
):
    """Data-parallel fused decode across a device mesh (config 3 at
    multi-device scale, SURVEY.md §2.3 DP row): the image list splits into
    one contiguous chunk per device, each device runs the SAME fused
    wavefront+IDCT+color program on its chunk under shard_map, and the
    result is an [N, H, W(,3)] array sharded on the batch axis.

    Requires a uniform batch and len(jpegs) divisible by the mesh size.
    Returns (rgb, failures)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from . import pipeline as kernel_pipeline

    if mesh is None:
        mesh = jax.make_mesh((jax.device_count(),), (axis,))
    d = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    n = len(jpegs)
    if n % d != 0:
        raise JpegUnsupportedError(
            f"sharded decode needs len(jpegs) % {d} == 0, got {n}"
        )
    per = n // d
    chunks = [jpegs[i * per : (i + 1) * per] for i in range(d)]
    plans = [build_block_plan(c) for c in chunks]
    w_max = max(p.n_words for p in plans)
    plans = [build_block_plan(c, min_words=w_max) for c in chunks]
    p0 = plans[0]
    if not p0.qsets:
        raise JpegUnsupportedError("sharded decode: too many quantizer sets")
    for p in plans[1:]:
        if (
            p.bits.shape != p0.bits.shape
            or p.blk_tables != p0.blk_tables
            or p.qsets != p0.qsets
            or p.img_qset != p0.img_qset
            or p.n_mcus != p0.n_mcus
        ):
            raise JpegUnsupportedError(
                "sharded decode needs identical chunk structure"
            )

    plan_static = p0.static_key("pixels")
    frame = chunks[0][0].frame

    def local(bits, lane_m, seg_bits, lane_qset):
        # One device's chunk: [1, ...] shard -> squeeze the device dim.
        out, err = run_wavefront(
            bits[0], lane_m[0], seg_bits[0], plan_static, p0.n_groups,
            lane_qset[0],
        )
        stacked = assemble_pixels_stacked(
            (p0.blocks_per_mcu, p0.n_mcus, p0.n_groups),
            out,
            tuple(ImageGeom.of(j) for j in chunks[0]),
        )
        rgb = kernel_pipeline.transform_planes_batch(
            frame, stacked, config, color=bitstream.color_space(chunks[0][0])
        )
        return rgb, err[None]

    fn = jax.jit(
        shard_map(
            local,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis)),
            out_specs=(P(axis), P(axis)),
            check_vma=False,
        )
    )
    bits = jnp.asarray(np.stack([p.bits for p in plans]))
    lane_m = jnp.asarray(np.stack([p.lane_m for p in plans]))
    seg_bits = jnp.asarray(np.stack([p.seg_bits for p in plans]))
    lane_qset = jnp.asarray(np.stack([p.lane_qset for p in plans]))
    rgb, err = fn(bits, lane_m, seg_bits, lane_qset)

    failures: Dict[int, Exception] = {}
    errs = np.asarray(err)
    for di in range(d):
        e = errs[di].reshape(-1)[: plans[di].n_lanes]
        for img, exc in failures_from_err(e, plans[di].lane_meta).items():
            failures.setdefault(di * per + img, exc)
    return rgb, failures
