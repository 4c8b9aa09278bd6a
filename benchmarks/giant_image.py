"""Giant-image decode benchmark (config 5 family, BASELINE.json:11):
one huge restart-segmented JPEG decoded fully on-device — every restart
segment becomes a wavefront lane, so a single image saturates the GPU
the same way a batch does. (True multi-device MCU-row sharding with
halo exchange lives in tpujpeg/parallel/halo.py and benchmarks/
scaling.py; this measures the single-GPU giant-image path.)

Usage: python benchmarks/giant_image.py  -> one JSON line.
Env: GIANT_SIZE (default 8192), GIANT_RST_BLOCKS (default 2).
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

    size = int(os.environ.get("GIANT_SIZE", "8192"))
    rst = int(os.environ.get("GIANT_RST_BLOCKS", "2"))
    data = make_jpeg(size, size, seed=11, quality=85, subsampling=2,
                     restart_blocks=rst)
    mp = size * size / 1e6

    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # 16K^2 = 268 MP trips the bomb guard

    im = Image.open(io.BytesIO(data)); im.load()  # warm
    t0 = time.perf_counter()
    im = Image.open(io.BytesIO(data)); im.load()
    anchor = mp / (time.perf_counter() - t0)

    import jax
    import jax.numpy as jnp
    import tpujpeg
    from tpujpeg import bitstream
    from tpujpeg.config import DecodeConfig
    from tpujpeg.kernels import wavefront_pallas as wp

    if jax.default_backend() != "gpu":
        sys.exit(f"{__file__}: needs a GPU (JAX backend "
                 f"{jax.default_backend()!r})")
    cfg = DecodeConfig()
    csum = jax.jit(lambda x: jnp.sum(x.astype(jnp.int32)))

    # Host prep (parse + plan), timed separately like bench.py.
    t0 = time.perf_counter()
    jpeg = bitstream.parse(data)
    plan = wp.build_block_plan([jpeg])
    host_prep_s = time.perf_counter() - t0

    # Stage plan arrays in device memory (excluded from the clock —
    # bench.py methodology).
    t0 = time.perf_counter()
    bits = jax.device_put(jnp.asarray(plan.bits))
    lane_m = jax.device_put(jnp.asarray(plan.lane_m))
    seg_bits = jax.device_put(jnp.asarray(plan.seg_bits))
    lane_q = jax.device_put(jnp.asarray(plan.lane_qset))
    _ = np.asarray(lane_m)[:1]
    upload_s = time.perf_counter() - t0

    fn = wp._rgb_chain(plan, [jpeg], cfg)
    rgb, err = fn(bits, lane_m, seg_bits, lane_q)
    _ = int(csum(rgb))  # compile + warm (true sync)
    assert not np.asarray(err).reshape(-1)[: plan.n_lanes].any()

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        rgb, err = fn(bits, lane_m, seg_bits, lane_q)
        _ = int(csum(rgb))
        times.append(time.perf_counter() - t0)
    value = mp / min(times)

    exact = bool(np.array_equal(np.asarray(rgb[0]), np.asarray(im)))
    print(
        json.dumps(
            {
                "metric": f"giant_image_ondevice_decode_mp_per_s_{size}x{size}",
                "value": round(value, 1),
                "unit": "MP/s",
                "vs_baseline": round(value / anchor, 3),
                "detail": {
                    "libjpeg_turbo_1core_mp_per_s": round(anchor, 1),
                    "bit_exact_vs_pil": exact,
                    "wavefront_lanes": plan.n_lanes,
                    "host_prep_mp_per_s": round(mp / host_prep_s, 1),
                    "staged_upload_s": round(upload_s, 3),
                    "includes": "full on-device decode, inputs staged in device memory",
                    "platform": jax.devices()[0].platform,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
