"""Multi-device scaling benchmark (SURVEY.md §4 perf row; config 5
BASELINE.json:11): MCU-row-sharded decode of one giant image across
every GPU of the machine with halo exchange, reporting scaling
efficiency 1 -> N devices. Fails when JAX finds fewer than two GPUs
(the sharding logic itself is tested on virtual CPU devices by
tests/test_parallel.py).

Usage: python benchmarks/scaling.py  -> one JSON line.
Env: SCALING_SIZE (default 4096).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from corpus import make_jpeg, pil_decode

from tpujpeg import bitstream
from tpujpeg.decoder import _entropy_decode
from tpujpeg.config import DecodeConfig
from tpujpeg.parallel import halo
from tpujpeg.stats import DecodeStats


def timed_sharded(data, n_shards, repeats=3):
    jpeg = bitstream.parse(data)
    frame = jpeg.frame
    coeffs = _entropy_decode(jpeg, DecodeConfig(), DecodeStats())
    key = (
        frame.height, frame.width,
        tuple((c.h, c.v) for c in frame.components), 0,
    )
    fn, _, mesh = halo._build_sharded_transform(key, n_shards, "rows", True)
    from jax.sharding import NamedSharding, PartitionSpec as P

    grids = [
        jax.device_put(
            coeffs[ci].reshape(c.padded_hb, c.padded_wb, 64),
            NamedSharding(mesh, P("rows")),
        )
        for ci, c in enumerate(frame.components)
    ]
    qtabs = [jnp.asarray(jpeg.qtables[c.tq]) for c in frame.components]
    out = jax.block_until_ready(fn(grids, qtabs))  # compile + warm
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(grids, qtabs))
        times.append(time.perf_counter() - t0)
    return min(times), out


def main():
    n = len(jax.devices())
    if jax.default_backend() != "gpu" or n < 2:
        sys.exit(f"{__file__}: needs two or more GPUs (JAX backend "
                 f"{jax.default_backend()!r}, {n} devices)")
    size = int(os.environ.get("SCALING_SIZE", "4096"))
    data = make_jpeg(size, size, seed=3, quality=85, subsampling=2,
                     restart_rows=1)
    mp = size * size / 1e6

    t1, out1 = timed_sharded(data, 1)
    tn, outn = timed_sharded(data, n)
    exact = bool(
        np.array_equal(
            np.asarray(outn)[:size, :size], pil_decode(data)
        )
    )
    speedup = t1 / tn
    print(
        json.dumps(
            {
                "metric": f"sharded_transform_scaling_{size}x{size}_{n}dev",
                "value": round(speedup / n, 3),
                "unit": "efficiency",
                "detail": {
                    "t_1dev_ms": round(t1 * 1e3, 1),
                    f"t_{n}dev_ms": round(tn * 1e3, 1),
                    "speedup": round(speedup, 2),
                    "mp": mp,
                    "bit_exact_vs_pil": exact,
                    "platform": jax.devices()[0].platform,
                    "device_kind": jax.devices()[0].device_kind,
                    "device_count": n,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
