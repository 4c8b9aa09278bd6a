"""CLI driver (SURVEY.md §1 L5 / §2.1 #19): the successor of the
reference's `decode <in.jpg> <out.bmp>` main() with timing printout.

Usage:
    python -m tpujpeg.cli decode in.jpg out.png [--engine=...] [--profile DIR]
    python -m tpujpeg.cli info in.jpg
    python -m tpujpeg.cli bench in.jpg [--repeats N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import bitstream
from .config import DecodeConfig
from .decoder import decode


def _write_output(path: str, arr: np.ndarray) -> None:
    if path.endswith(".ppm") or path.endswith(".pgm"):
        # Native PPM/PGM writer (component #18's BMP/PPM dump equivalent)
        # so the CLI works without PIL.
        with open(path, "wb") as f:
            if arr.ndim == 2:
                f.write(b"P5\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            else:
                f.write(b"P6\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            f.write(arr.tobytes())
        return
    if path.endswith(".npy"):
        np.save(path, arr)
        return
    from PIL import Image

    if arr.ndim == 3 and arr.shape[-1] == 4:
        # Adobe CMYK/YCCK decode output (PIL 'CMYK' convention); PNG et
        # al. can't hold CMYK, so this needs a .jpg/.tif/.npy target.
        Image.fromarray(arr, mode="CMYK").save(path)
        return
    Image.fromarray(arr).save(path)


def _cfg_from_args(args) -> DecodeConfig:
    return DecodeConfig(
        entropy_engine=args.entropy,
        fancy_upsampling=not args.no_fancy,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpujpeg")
    sub = p.add_subparsers(dest="cmd", required=True)

    pd = sub.add_parser("decode", help="decode a JPEG to an image file")
    pd.add_argument("input")
    pd.add_argument("output")
    pd.add_argument("--entropy", default="auto",
                    choices=["auto", "python", "native", "wavefront"])
    pd.add_argument("--no-fancy", action="store_true")
    pd.add_argument("--profile", default=None, metavar="DIR",
                    help="dump a jax.profiler trace of the decode to DIR")

    pi = sub.add_parser("info", help="print parsed stream structure")
    pi.add_argument("input")

    pb = sub.add_parser("bench", help="timed repeated decode")
    pb.add_argument("input")
    pb.add_argument("--repeats", type=int, default=5)
    pb.add_argument("--entropy", default="auto",
                    choices=["auto", "python", "native", "wavefront"])
    pb.add_argument("--no-fancy", action="store_true")

    pba = sub.add_parser(
        "batch",
        help="decode many JPEGs to .npy with manifest-based resume "
             "(SURVEY.md §5 checkpoint/resume)",
    )
    pba.add_argument("inputs", nargs="+")
    pba.add_argument("--out", required=True, metavar="DIR")
    pba.add_argument("--manifest", default=None)
    pba.add_argument("--chunk", type=int, default=64)
    pba.add_argument("--on-device", action="store_true",
                     help="full on-device fused path (decode_batch_pipelined)")
    pba.add_argument("--entropy", default="auto",
                     choices=["auto", "python", "native", "wavefront"])
    pba.add_argument("--no-fancy", action="store_true")

    args = p.parse_args(argv)

    if args.cmd == "batch":
        from .parallel import manifest as manifest_lib

        counters = manifest_lib.run_batch_job(
            args.inputs,
            args.out,
            manifest_path=args.manifest,
            config=_cfg_from_args(args),
            chunk_size=args.chunk,
            on_device=args.on_device,
        )
        print(json.dumps(counters))
        return 0 if counters["failed"] == 0 else 2

    if args.cmd == "info":
        with open(args.input, "rb") as f:
            j = bitstream.parse(f.read())
        fr = j.frame
        info = {
            "width": fr.width,
            "height": fr.height,
            "progressive": fr.progressive,
            "components": [
                {"id": c.cid, "h": c.h, "v": c.v, "qtable": c.tq}
                for c in fr.components
            ],
            "mcus": [fr.mcus_x, fr.mcus_y],
            "color_space": bitstream.color_space(j),
            "scans": len(j.scans),
            "restart_interval": j.restart_interval,
            "segments": sum(len(s.rst_offsets) + 1 for s in j.scans),
        }
        print(json.dumps(info, indent=2))
        return 0

    with open(args.input, "rb") as f:
        data = f.read()
    cfg = _cfg_from_args(args)

    if args.cmd == "decode":
        if args.profile:
            import jax

            with jax.profiler.trace(args.profile):
                arr, stats = decode(data, cfg, return_stats=True)
        else:
            arr, stats = decode(data, cfg, return_stats=True)
        _write_output(args.output, arr)
        mp = stats.megapixels
        total = stats.t_parse + stats.t_entropy + stats.t_transform
        print(
            f"{stats.width}x{stats.height} "
            f"({'progressive' if stats.progressive else 'baseline'}, "
            f"{stats.n_scans} scan(s), {stats.n_segments} segment(s)) "
            f"entropy[{stats.entropy_engine}]={stats.t_entropy*1e3:.2f}ms "
            f"transform[{stats.transform_engine}]={stats.t_transform*1e3:.2f}ms "
            f"total={total*1e3:.2f}ms ({mp/total:.1f} MP/s)"
        )
        return 0

    if args.cmd == "bench":
        decode(data, cfg)  # warm-up / compile
        times = []
        all_stats = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            _, stats = decode(data, cfg, return_stats=True)
            times.append(time.perf_counter() - t0)
            all_stats.append(stats)
        best_i = int(np.argmin(times))
        best = times[best_i]
        stats = all_stats[best_i]  # engine identity of the reported run
        mp = stats.megapixels
        print(
            json.dumps(
                {
                    "megapixels": mp,
                    "best_ms": best * 1e3,
                    "mean_ms": float(np.mean(times)) * 1e3,
                    "mp_per_s": mp / best,
                    "entropy_engine": stats.entropy_engine,
                    "entropy_engines_seen": sorted(
                        {s.entropy_engine for s in all_stats}
                    ),
                }
            )
        )
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
