"""Roofline accounting for the fused wavefront+IDCT kernel (SURVEY.md §5
"roofline sanity"; VERDICT r4 missing #4 / next #6).

The kernel's work unit is a lockstep TRIP: all `lane_group` lanes of a
program advance one AC symbol of the SAME block position together, so a
program's trip count for one block is max_over_lanes(ac_symbols). Every
quantity below is computed EXACTLY from the decoded coefficients (each (run,
size) pair, ZRL and EOB reconstructs from the zigzag nonzero pattern)
plus the plan's real lane->group packing; nothing is sampled.

Reports, per the bench corpus:
  - symbols/MP and blocks/MP (the work the stream demands),
  - total lockstep trips and the divergence waste
    (1 - useful_symbol_slots / issued_symbol_slots),
  - measured kernel-only wall clock -> ns/trip and symbols/s,
  - device-memory bytes/MP of the full chain vs the memory roof of the
    device it ran on (PEAK_BYTES_PER_S, keyed by device_kind; an
    unknown device is an error).

Usage: python tools/roofline.py  ->  one JSON line.
Env: BENCH_SIZE/BENCH_BATCH/BENCH_RESTART_BLOCKS as bench.py.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np

# Device-memory bandwidth per device_kind (NVIDIA H100 SXM data sheet:
# 3.35 TB/s of HBM3 at the full 700 W power limit).
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def block_ac_symbols(zz: np.ndarray) -> np.ndarray:
    """Exact AC symbol count per block from zigzag coefficients
    [N, 64]: one (run,size) symbol per nonzero AC (plus run//16 ZRLs
    for gaps > 15), one EOB when the block ends early. T.81 F.1.2.2."""
    nz = zz[:, 1:] != 0  # [N, 63]
    n = zz.shape[0]
    syms = np.zeros(n, np.int64)
    run = np.zeros(n, np.int32)
    last = np.full(n, 0, np.int32)  # last nonzero zigzag index
    for k in range(63):
        hit = nz[:, k]
        # ZRLs consumed before this nonzero: run // 16.
        syms[hit] += run[hit] // 16 + 1
        run = np.where(hit, 0, run + 1)
        last = np.where(hit, k + 1, last)
    syms += (last < 63).astype(np.int64)  # EOB (incl. all-zero blocks)
    return syms


def main() -> int:
    from corpus import make_jpeg

    size = int(os.environ.get("BENCH_SIZE", "2048"))
    nimg = int(os.environ.get("BENCH_BATCH", "64"))
    rst = int(os.environ.get("BENCH_RESTART_BLOCKS", "4"))
    datas = [
        make_jpeg(size, size, seed=7 + i, quality=85, subsampling=2,
                  restart_blocks=rst)
        for i in range(nimg)
    ]
    total_mp = size * size * nimg / 1e6

    import jax
    import jax.numpy as jnp
    from tpujpeg import bitstream
    from tpujpeg.kernels import wavefront_pallas as wp
    from tpujpeg.native import entropy as ne

    jpegs = [bitstream.parse(d) for d in datas]
    plan = wp.build_block_plan(jpegs)
    B = plan.blocks_per_mcu
    lg = plan.lane_group
    G = plan.n_groups
    M = plan.n_mcus
    kind = jax.devices()[0].device_kind
    if kind not in PEAK_BYTES_PER_S:
        raise SystemExit(f"roofline: no peak bandwidth for {kind!r}")
    peak = PEAK_BYTES_PER_S[kind]

    # --- Exact per-(lane, mcu, block) AC symbol counts. ---
    # b_pos order must match _make_kernel: per scan comp, v-major then h.
    frame = jpegs[0].frame
    b_pos = []
    for sp, (ci, h, v) in enumerate(plan.comp_hv):
        for dv in range(v):
            for dh in range(h):
                b_pos.append((ci, dv, dh))
    assert len(b_pos) == B

    per_img_syms = []  # [n_mcus_img, B] per image
    total_ac = 0
    total_blocks = 0
    for j in jpegs:
        coeffs = ne.decode_all_scans(j)  # zigzag [pblocks, 64] per comp
        fr = j.frame
        n_mcu = fr.mcus_x * fr.mcus_y
        mc = np.arange(n_mcu)
        my, mx = mc // fr.mcus_x, mc % fr.mcus_x
        sy = np.empty((n_mcu, B), np.int32)
        for b, (ci, dv, dh) in enumerate(b_pos):
            c = fr.components[ci]
            rows = my * c.v + dv
            cols = mx * c.h + dh
            idx = rows * c.padded_wb + cols
            sy[:, b] = block_ac_symbols(coeffs[ci][idx])
        per_img_syms.append(sy)
        total_ac += int(sy.sum())
        total_blocks += n_mcu * B

    # --- Pack to plan lane order via lane_meta, pad groups. ---
    L = plan.n_lanes
    lane_meta = plan.lane_meta  # [L, 3] (img, first_mcu, n_mcus)
    S = np.zeros((G * lg, M, B), np.int32)
    for l in range(L):
        img, m0, nm = (int(x) for x in lane_meta[l])
        S[l, :nm] = per_img_syms[img][m0 : m0 + nm]
    S = S.reshape(G, lg, M, B)

    # --- Lockstep trips: program-max of per-lane symbols. ---
    trips = int(S.max(axis=1).sum())
    # Issued symbol slots = trips * lanes-in-program; useful slots =
    # actual symbols. The gap is divergence (lanes waiting on the
    # program's slowest lane).
    issued = trips * lg
    waste = 1.0 - total_ac / issued
    dc_rounds = G * M * B  # straight-line DC sections (one per grid pos)

    # --- Measured kernel-only wall clock (cached program). ---
    plan_static = plan.static_key("pixels")
    bits = jax.device_put(jnp.asarray(plan.bits))
    lane_m = jax.device_put(jnp.asarray(plan.lane_m))
    seg_bits = jax.device_put(jnp.asarray(plan.seg_bits))
    lane_q = jax.device_put(jnp.asarray(plan.lane_qset))
    _ = np.asarray(lane_m)[:1]

    @jax.jit
    def prog_a(bits, lane_m, seg_bits, lane_q):
        out, err = wp.run_wavefront(
            bits, lane_m, seg_bits, plan_static, plan.n_groups, lane_q,
        )
        dep = sum(jnp.sum(o[..., -1].astype(jnp.int32)) for o in out)
        return dep + jnp.sum(err)

    _ = int(prog_a(bits, lane_m, seg_bits, lane_q))  # compile+warm
    times = []
    for _i in range(3):
        t0 = time.perf_counter()
        _ = int(prog_a(bits, lane_m, seg_bits, lane_q))
        times.append(time.perf_counter() - t0)
    kernel_s = min(times)

    # Per-program-trip wall clock: programs run CONCURRENTLY across the
    # SMs, so wall ns/trip reflects both the serial chain and overlap.
    ns_per_trip = kernel_s * 1e9 / trips

    # --- Device-memory traffic of the full chain (theoretical bytes). ---
    px = size * size * nimg
    bytes_in = plan.bits.nbytes
    # kernel out: packed int32 words, sum(v*8*h*2) words per MCU.
    out_words_mcu = sum(v * 8 * h * 2 for _ci, h, v in plan.comp_hv)
    bytes_kernel_out = 4 * out_words_mcu * int(lane_meta[:, 2].sum())
    # assembly: two transposes, each read+write of the planar samples.
    planar = bytes_kernel_out  # == 1.5 B/px at 4:2:0
    bytes_assembly = 4 * planar
    # color: read planar, write packed16 RGB (3 B/px).
    bytes_color = planar + 3 * px
    hbm_total = bytes_in + 2 * bytes_kernel_out + bytes_assembly + bytes_color
    hbm_roof_s = hbm_total / peak

    print(json.dumps({
        "metric": "roofline_fused_kernel",
        "corpus": f"{nimg}x{size}^2 q85 420 rst{rst}",
        "work": {
            "blocks": total_blocks,
            "ac_symbols": total_ac,
            "ac_symbols_per_block": round(total_ac / total_blocks, 2),
            "symbols_per_mp": round((total_ac + total_blocks) / total_mp),
        },
        "lockstep": {
            "lane_group": lg,
            "groups": G,
            "trips": trips,
            "dc_rounds": dc_rounds,
            "divergence_waste": round(waste, 4),
            "mean_lane_trips_over_max": round(
                float(S.mean(axis=1).sum()) / trips, 4
            ),
        },
        "measured": {
            "kernel_s": round(kernel_s, 4),
            "kernel_mp_per_s": round(total_mp / kernel_s, 1),
            "ns_per_group_trip": round(ns_per_trip, 2),
            "ac_symbols_per_s": round(total_ac / kernel_s / 1e9, 3),
            "platform": jax.devices()[0].platform,
            "device_kind": kind,
        },
        "hbm": {
            "bytes_per_px": round(hbm_total / px, 2),
            "chain_bytes_total": hbm_total,
            "peak_bytes_per_s": peak,
            "hbm_time_at_peak_s": round(hbm_roof_s, 4),
            "hbm_bound_mp_per_s": round(total_mp / hbm_roof_s, 1),
            "fraction_of_hbm_roof": round(hbm_roof_s / kernel_s, 4),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
