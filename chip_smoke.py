"""GPU smoke test: drive tpujpeg's decode path once through its user entry
points at real sizes, with every kernel compiled for the card, and check
each output bit-exactly against the plain reference (native host entropy
+ the jnp transform run on the CPU device) and, where Pillow imports,
against PIL/libjpeg-turbo.

    python chip_smoke.py           # one GPU: phases A-E
    python chip_smoke.py --multi   # four GPUs: the sharded paths only

Phases (one GPU):
  A  decode_stream, 2 chunks x 64 images of 2048^2 q85 4:2:0, restart
     every 4 MCUs, once with layout="nhwc" and once with "packed16"
  B  decode_batch_on_device on a mixed batch: ImageNet-sized files,
     3840x2160 q95 4:4:4 and 4:2:2, a marker-free 2048^2, a two-file
     progressive group with shared tables and a singleton progressive
     file, grayscale and Adobe CMYK
  C  decode() of a 4096^2 file (the fused single dispatch)
  D  each kernel against its plain reference at real widths
  E  the native host library builds and loads

Exits non-zero on any failure and when JAX finds no GPU. Everything is
printed on earlier lines; the last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


class Ctx:
    """What the phases share: the modules, the corpus and the oracles."""

    def __init__(self, jax):
        sys.path.insert(0, HERE)
        sys.path.insert(0, os.path.join(HERE, "tests"))
        import numpy as np

        import tpujpeg
        from tpujpeg import backend, bitstream
        from tpujpeg.config import DecodeConfig

        self.jax = jax
        self.np = np
        self.tpujpeg = tpujpeg
        self.bitstream = bitstream
        self.DecodeConfig = DecodeConfig
        self.cpu = jax.devices("cpu")[0]
        assert not backend.pallas_interpret(), "kernels would be interpreted"
        try:
            import corpus
            from PIL import Image
        except ImportError as e:  # Pillow missing: no corpus, no PIL oracle
            raise RuntimeError(f"tests/corpus.py needs Pillow: {e!r}")
        Image.MAX_IMAGE_PIXELS = None  # the 16384^2 file is 268 MP
        self.corpus = corpus
        self._ref = {}

    def make(self, w, h, **kw):
        return self.corpus.make_jpeg(w, h, **kw)

    def plain(self, data: bytes):
        """The plain reference: native host entropy + transform.py's jnp
        transform, run on the CPU device."""
        key = hash(data)
        if key not in self._ref:
            with self.jax.default_device(self.cpu):
                out = self.tpujpeg.decode(
                    data, self.DecodeConfig(entropy_engine="native")
                )
            self._ref[key] = self.np.asarray(out)
        return self._ref[key]

    def check(self, got, data: bytes, what: str) -> None:
        """Exact against the plain reference, and against PIL."""
        np = self.np
        got = np.asarray(got)
        ref = self.plain(data)
        if got.shape != ref.shape or not np.array_equal(got, ref):
            bad = (got != ref).mean() if got.shape == ref.shape else "shape"
            raise AssertionError(f"{what}: differs from plain reference ({bad})")
        pil = self.corpus.pil_decode(data)
        if not np.array_equal(ref, pil):
            raise AssertionError(f"{what}: plain reference differs from PIL")


def _peak(jax) -> int:
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


# ---------------------------------------------------------------------------
# One-GPU phases
# ---------------------------------------------------------------------------


def phase_e(ctx: Ctx) -> None:
    from tpujpeg.native import build as native_build

    t0 = time.perf_counter()
    lib = native_build.get_lib()
    print(f"  native library: {lib._name} "
          f"({time.perf_counter() - t0:.3f} s to build/load)")


def phase_a(ctx: Ctx) -> None:
    jax, np, tj = ctx.jax, ctx.np, ctx.tpujpeg
    from tpujpeg.kernels import wavefront_pallas as wp

    distinct = [
        ctx.make(2048, 2048, seed=100 + i, quality=85, subsampling=2,
                 restart_blocks=4)
        for i in range(8)
    ]
    datas = [distinct[i % 8] for i in range(128)]
    for i, d in enumerate(distinct):
        ctx.plain(d)

    # The main chain, compiled explicitly for its memory analysis.
    jpegs = [ctx.bitstream.parse(d) for d in datas[:64]]
    plan = wp.build_block_plan(jpegs)
    fn = wp._rgb_chain(plan, jpegs, ctx.DecodeConfig())
    args = [jax.numpy.asarray(a) for a in
            (plan.bits, plan.lane_m, plan.seg_bits, plan.lane_qset)]
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    print(f"  main chain (64 x 2048^2, {plan.n_lanes} lanes, "
          f"{plan.n_groups} programs) compile s: "
          f"{time.perf_counter() - t0:.2f}")
    print(f"  main chain memory_analysis: {compiled.memory_analysis()}")

    for layout in ("nhwc", "packed16"):
        t0 = time.perf_counter()
        n = 0
        for chunk in tj.decode_stream(datas, chunk_size=64, layout=layout):
            assert chunk.engine == "wavefront-fused", chunk.engine
            assert chunk.layout == layout, chunk.layout
            assert not chunk.failures, chunk.failures
            for k, i in enumerate(chunk.members):
                img = np.asarray(chunk.images[k])
                if layout == "packed16":
                    h, w2 = img.shape[1], img.shape[2]
                    img = img.view(np.uint8).reshape(3, h, 2 * w2)
                    img = img.transpose(1, 2, 0)
                ctx.check(img, datas[i], f"stream {layout} image {i}")
                n += 1
        assert n == 128, n
        print(f"  decode_stream layout={layout}: 128 images exact "
              f"({time.perf_counter() - t0:.2f} s incl. compile)")
    print(f"  peak_bytes_in_use: {_peak(jax)}")


def _cmyk_jpeg(w, h, seed):
    import io

    import numpy as np
    from PIL import Image

    arr = np.random.default_rng(seed).integers(
        0, 256, size=(h, w, 4), dtype=np.uint8
    )
    arr[: h // 2] //= 3  # some structure beside the noise
    buf = io.BytesIO()
    Image.fromarray(arr, "CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def phase_b(ctx: Ctx) -> None:
    tj = ctx.tpujpeg
    prog_shared = ctx.make(1024, 768, seed=7, progressive=True,
                           restart_blocks=8)
    files = [
        # ImageNet-sized, mixed geometry: marker-free like real shards,
        # plus restart-segmented ones.
        (ctx.make(500, 375, seed=1, quality=90), "wavefront-skeleton"),
        (ctx.make(375, 500, seed=2, quality=85), "wavefront-skeleton"),
        (ctx.make(500, 333, seed=3, quality=92, subsampling=1),
         "wavefront-skeleton"),
        (ctx.make(640, 480, seed=4, quality=75, restart_blocks=4),
         "wavefront-fused"),
        (ctx.make(640, 480, seed=5, quality=80, restart_blocks=4),
         "wavefront-fused"),
        # Camera originals (config 2).
        (ctx.make(3840, 2160, seed=6, quality=95, subsampling=0,
                  restart_blocks=4), "wavefront-fused"),
        (ctx.make(3840, 2160, seed=8, quality=95, subsampling=1,
                  restart_blocks=4), "wavefront-fused"),
        # Marker-free 2048^2: skeleton-split lanes.
        (ctx.make(2048, 2048, seed=9, quality=85), "wavefront-skeleton"),
        # Progressive: a two-file group sharing tables, and a singleton.
        (prog_shared, "wavefront-prog"),
        (prog_shared, "wavefront-prog"),
        (ctx.make(800, 600, seed=10, progressive=True, restart_blocks=4),
         "wavefront-prog"),
        (ctx.make(1024, 768, seed=11, mode="L", restart_blocks=4),
         "wavefront-fused"),
        (_cmyk_jpeg(640, 480, seed=12), "wavefront-skeleton"),
    ]
    datas = [d for d, _e in files]
    t0 = time.perf_counter()
    res = tj.decode_batch_on_device(datas)
    dt = time.perf_counter() - t0
    assert not res.errors, res.errors
    for i, ((d, want), st) in enumerate(zip(files, res.stats)):
        assert st.entropy_engine == want, (i, st.entropy_engine, want)
        ctx.check(res.images[i], d, f"batch image {i} ({want})")
        print(f"  batch image {i}: {st.width}x{st.height} "
              f"{st.entropy_engine} exact")
    print(f"  decode_batch_on_device: {len(datas)} images "
          f"({dt:.2f} s incl. compile)")


def phase_c(ctx: Ctx) -> None:
    data = ctx.make(4096, 4096, seed=13, quality=85, restart_blocks=4)
    t0 = time.perf_counter()
    img, st = ctx.tpujpeg.decode(data, return_stats=True)
    dt = time.perf_counter() - t0
    assert st.entropy_engine == "wavefront-fused", st.entropy_engine
    ctx.check(img, data, "decode 4096^2")
    print(f"  decode(4096^2): {st.entropy_engine} exact "
          f"({dt:.2f} s incl. compile)")


def phase_d(ctx: Ctx) -> None:
    jax, np, bs = ctx.jax, ctx.np, ctx.bitstream
    from tpujpeg import transform as T
    from tpujpeg.kernels import wavefront_pallas as wp
    from tpujpeg.kernels import wavefront_prog as wprog
    from tpujpeg.native import entropy as ne

    # Coefficient-emit wavefront vs native host coefficients.
    datas = [ctx.make(2048, 2048, seed=100 + i, quality=85, subsampling=2,
                      restart_blocks=4) for i in range(4)]
    jpegs = [bs.parse(d) for d in datas]
    t0 = time.perf_counter()
    comps, failures = wp.decode_batch_to_device(jpegs)
    assert not failures, failures
    for j, got in zip(jpegs, comps):
        for ci, (a, b) in enumerate(zip(ne.decode_all_scans(j), got)):
            assert np.array_equal(a, np.asarray(b)), f"coeff comp {ci}"
    print(f"  wavefront coeff emit, 4 x 2048^2: exact vs native "
          f"({time.perf_counter() - t0:.2f} s incl. compile)")

    # Fused pixels emit vs the plain reference (transform.py on CPU).
    t0 = time.perf_counter()
    rgb, failures = wp.decode_batch_to_rgb(jpegs)
    assert not failures, failures
    for i, d in enumerate(datas):
        ctx.check(rgb[i], d, f"fused rgb {i}")
    print(f"  wavefront pixels emit + jnp color, 4 x 2048^2: exact vs "
          f"transform.py on CPU ({time.perf_counter() - t0:.2f} s)")

    # Progressive scan kernels vs native progressive entropy: a group
    # of two sharing tables, then a file with other tables through the
    # same compiled chain (tables are runtime operands).
    pdatas = [ctx.make(2048, 2048, seed=s, quality=85, progressive=True,
                       restart_blocks=8) for s in (14, 15)]
    pjs = [bs.parse(d) for d in pdatas]
    ref = ne.decode_all_scans(pjs[0])
    t0 = time.perf_counter()
    states, dcs, failures = wprog.decode_all_scans_batch([pjs[0], pjs[0]])
    assert not failures, failures
    for st, dc in zip(states, dcs):
        for ci, (a, s, c) in enumerate(zip(ref, st, dc)):
            m = np.array(s)
            m[:, 0] = np.asarray(c)
            assert np.array_equal(a, m), f"progressive comp {ci}"
    assert wprog.scan_group_key(pjs[0]) != wprog.scan_group_key(pjs[1])
    for d, j in zip(pdatas, pjs):
        rgb, _layout, failures = wprog.decode_all_scans_to_rgb_batch([j])
        assert not failures, failures
        ctx.check(rgb[0], d, "progressive rgb")
    print(f"  progressive scan kernels, 2048^2 ({len(pjs[0].scans)} scans): "
          f"exact vs native and the plain reference, two table sets "
          f"({time.perf_counter() - t0:.2f} s incl. compile)")

    # Matmul IDCT at HIGHEST vs islow: a float basis against fixed
    # point, so <= 1 LSB on under 5% of samples.
    coeffs = ne.decode_all_scans(jpegs[0])[0]
    q = jpegs[0].qtables[jpegs[0].frame.components[0].tq]
    got = np.asarray(jax.jit(T.dequant_idct_matmul)(coeffs, q)).astype(int)
    with jax.default_device(ctx.cpu):
        want = np.asarray(T.idct8x8_islow(T.dequantize(coeffs, q))).astype(int)
    diff = np.abs(got - want)
    share = float((diff > 0).mean())
    assert diff.max() <= 1 and share < 0.05, (diff.max(), share)
    print(f"  idct=matmul (HIGHEST) vs islow on {len(coeffs)} blocks: "
          f"max diff {diff.max()}, {share:.4%} of samples differ")


# ---------------------------------------------------------------------------
# Four-GPU phases (--multi)
# ---------------------------------------------------------------------------


def _spans(arr, n: int) -> int:
    devs = len(arr.sharding.device_set)
    assert devs == n, f"output spans {devs} devices, want {n}"
    return devs


def phase_m_halo(ctx: Ctx) -> None:
    from tpujpeg.parallel import halo

    size = 16384
    data = ctx.make(size, size, seed=21, quality=85, restart_blocks=4)
    t0 = time.perf_counter()
    out = halo.decode_sharded(
        data, n_shards=4, config=ctx.DecodeConfig(to_numpy=False)
    )
    out.block_until_ready()
    dt = time.perf_counter() - t0
    devs = _spans(out, 4)
    out = ctx.np.asarray(out)
    single = halo.decode_sharded(data, n_shards=1)
    assert ctx.np.array_equal(out, single), "sharded != single-card"
    ctx.check(out, data, "halo.decode_sharded")
    print(f"  halo.decode_sharded {size}^2 over {devs} devices: exact vs "
          f"single-card decode, plain reference and PIL "
          f"({dt:.2f} s incl. compile)")


def phase_m_norst(ctx: Ctx) -> None:
    np = ctx.np
    from tpujpeg.kernels import wavefront_pallas as wp
    from tpujpeg.native import entropy as ne

    data = ctx.make(4096, 4096, seed=22, quality=85)  # marker-free
    j = ctx.bitstream.parse(data)
    assert len(j.scans[0].rst_offsets) == 0
    t0 = time.perf_counter()
    comps = wp.decode_norst_sharded(j)
    dt = time.perf_counter() - t0
    devs = _spans(comps[0], 4)
    single = wp.decode_norst_to_device(j)
    for ci, (a, b, c) in enumerate(zip(ne.decode_all_scans(j), comps, single)):
        assert np.array_equal(a, np.asarray(b)), f"sharded comp {ci}"
        assert np.array_equal(a, np.asarray(c)), f"single comp {ci}"
    print(f"  decode_norst_sharded 4096^2 marker-free over {devs} devices: "
          f"exact vs native and single-card ({dt:.2f} s incl. compile)")


def phase_m_batch(ctx: Ctx) -> None:
    np = ctx.np
    from tpujpeg.kernels import wavefront_pallas as wp

    distinct = [ctx.make(1024, 768, seed=30 + i, quality=85,
                         restart_blocks=4) for i in range(8)]
    datas = [distinct[i % 8] for i in range(64)]
    jpegs = [ctx.bitstream.parse(d) for d in datas]
    t0 = time.perf_counter()
    rgb, failures = wp.decode_batch_to_rgb_sharded(jpegs)
    rgb.block_until_ready()
    dt = time.perf_counter() - t0
    assert not failures, failures
    devs = _spans(rgb, 4)
    host = np.asarray(rgb)
    for i, d in enumerate(datas):
        ctx.check(host[i], d, f"sharded batch image {i}")
    # Single-card decode of each distinct file (staged path on card 0).
    for i, d in enumerate(distinct):
        single = ctx.tpujpeg.decode(
            d, ctx.DecodeConfig(entropy_engine="native")
        )
        assert np.array_equal(host[i], np.asarray(single)), "sharded != single"
    print(f"  decode_batch_to_rgb_sharded 4 x 16 images over {devs} "
          f"devices: exact vs single-card and reference ({dt:.2f} s)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded phases")
    args = ap.parse_args()

    import jax

    if jax.default_backend() != "gpu":
        return _fail(f"no GPU: JAX's backend is {jax.default_backend()!r}")
    want = 4 if args.multi else 1
    if len(jax.devices()) < want:
        return _fail(f"need {want} GPUs, found {len(jax.devices())}")
    try:
        ctx = Ctx(jax)
    except ImportError as e:
        return _fail(f"run from a checkout of the repository: {e!r}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(smi)
    print(f"jax {jax.__version__}; devices: {jax.devices()}")

    if args.multi:
        phases = [("M1 halo.decode_sharded", phase_m_halo),
                  ("M2 decode_norst_sharded", phase_m_norst),
                  ("M3 decode_batch_to_rgb_sharded", phase_m_batch)]
    else:
        phases = [("E native library", phase_e),
                  ("A decode_stream", phase_a),
                  ("B decode_batch_on_device", phase_b),
                  ("C decode", phase_c),
                  ("D kernels vs plain reference", phase_d)]
    ok = True
    for name, fn in phases:
        print(f"phase {name}:", flush=True)
        t0 = time.perf_counter()
        try:
            fn(ctx)
            print(f"phase {name}: ok ({time.perf_counter() - t0:.2f} s)",
                  flush=True)
        except Exception:
            ok = False
            traceback.print_exc()
            print(f"phase {name}: FAILED", flush=True)
    print(f"peak_bytes_in_use: {_peak(jax)}")
    if not ok:
        return 1
    d = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
