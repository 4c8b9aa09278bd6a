"""Marker-free giant-image decode benchmark (the BASELINE.json:5
"no-restart streams" edge; SURVEY.md §5 long-context items 3-4): one
huge baseline JPEG with NO restart markers. The host turns the serial
bitstream into wavefront lanes with the SPECULATIVE parallel skeleton
scan (tj_scan_split_spec — self-syncing workers + validating stitch,
which also records each lane's absolute DC predictors), and the device
runs the SAME fully fused wavefront+IDCT+upsample+color chain as
restart-segmented streams — lanes are DC-primed, so no prefix fixup
pass and no separate transform dispatch.

Reports the host prep rate (parse + destuff + speculative split + plan,
the stage that bound this path when the skeleton scan was serial) and
the device decode rate separately, bench.py methodology (inputs staged
in device memory before the clock).

Usage: python benchmarks/norst_image.py -> one JSON line.
Env: NORST_SIZE (default 8192).
"""

import io
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    from corpus import make_jpeg

    size = int(os.environ.get("NORST_SIZE", "8192"))
    data = make_jpeg(size, size, seed=11, quality=85, subsampling=2)
    mp = size * size / 1e6

    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None

    im = Image.open(io.BytesIO(data)); im.load()  # warm
    t0 = time.perf_counter()
    im = Image.open(io.BytesIO(data)); im.load()
    anchor = mp / (time.perf_counter() - t0)

    import jax
    import jax.numpy as jnp
    from tpujpeg import bitstream
    from tpujpeg.config import DecodeConfig
    from tpujpeg.kernels import pipeline as kernel_pipeline
    from tpujpeg.kernels import wavefront_pallas as wp

    if jax.default_backend() != "gpu":
        sys.exit(f"{__file__}: needs a GPU (JAX backend "
                 f"{jax.default_backend()!r})")
    cfg = DecodeConfig()
    csum = jax.jit(lambda x: jnp.sum(x.astype(jnp.int32)))

    # Host prep: parse + destuff + SPECULATIVE skeleton split + plan.
    wp.build_norst_plan(bitstream.parse(data))  # warm the native lib
    t0 = time.perf_counter()
    jpeg = bitstream.parse(data)
    plan = wp.build_norst_plan(jpeg)
    host_prep_s = time.perf_counter() - t0

    # Stage plan arrays in device memory (excluded from the clock).
    t0 = time.perf_counter()
    bits = jax.device_put(jnp.asarray(plan.bits))
    lane_m = jax.device_put(jnp.asarray(plan.lane_m))
    seg_bits = jax.device_put(jnp.asarray(plan.seg_bits))
    lane_qset = jax.device_put(jnp.asarray(plan.lane_qset))
    bit0 = jax.device_put(jnp.asarray(plan.bit0))
    dc0 = jax.device_put(jnp.asarray(plan.lane_dc0))
    _ = int(csum(lane_m))
    upload_s = time.perf_counter() - t0

    color = bitstream.color_space(jpeg)
    packed = kernel_pipeline.packed_layout_applies(jpeg.frame, cfg, color)
    fn = wp._rgb_chain(plan, [jpeg], cfg, packed=packed)

    def device_decode():
        return fn(bits, lane_m, seg_bits, lane_qset, bit0, dc0)

    rgb, err = device_decode()
    _ = int(csum(err))  # compile + warm, true sync
    assert not np.asarray(err).reshape(-1)[: plan.n_lanes].any()

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        rgb, err = device_decode()
        _ = int(csum(err))
        times.append(time.perf_counter() - t0)
    value = mp / min(times)

    got = np.asarray(rgb[0])
    if packed:
        got = (
            got.view(np.uint8).reshape(3, size, size).transpose(1, 2, 0)
        )
    exact = bool(np.array_equal(got, np.asarray(im)))
    print(
        json.dumps(
            {
                "metric": (
                    f"norst_image_ondevice_decode_mp_per_s_{size}x{size}"
                ),
                "value": round(value, 1),
                "unit": "MP/s",
                "vs_baseline": round(value / anchor, 3),
                "detail": {
                    "libjpeg_turbo_1core_mp_per_s": round(anchor, 1),
                    "bit_exact_vs_pil": exact,
                    "wavefront_lanes": plan.n_lanes,
                    "host_prep_mp_per_s": round(mp / host_prep_s, 1),
                    "staged_upload_s": round(upload_s, 3),
                    "includes": (
                        "speculative parallel skeleton scan on host;"
                        " on-device DC-primed fused wavefront+IDCT+"
                        "upsample+color chain, inputs staged in device memory"
                    ),
                    "layout": "packed16" if packed else "nhwc",
                    "platform": jax.devices()[0].platform,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
