"""The backend decision, the layouts and build keys around the kernels,
and the chip smoke script's refusal to run without a GPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax.numpy as jnp

from corpus import make_jpeg, pil_decode

import tpujpeg
from tpujpeg import backend, bitstream, huffman
from tpujpeg.kernels import pipeline as pipe_k
from tpujpeg.kernels import wavefront_pallas as wp
from tpujpeg.native import build as native_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "platform,interpret", [("gpu", False), ("cpu", True), ("rocm", None)]
)
def test_backend_decision(platform, interpret):
    """gpu compiles the kernels, cpu interprets them, anything else is
    refused by name."""
    if interpret is None:
        with pytest.raises(RuntimeError, match=platform):
            backend.pallas_interpret(platform)
    else:
        assert backend.pallas_interpret(platform) is interpret


def test_packed16_is_bitcast_of_planar_raster():
    rgb = np.random.default_rng(3).integers(
        0, 256, size=(2, 5, 8, 3), dtype=np.uint8
    )
    packed = np.asarray(pipe_k.pack16(jnp.asarray(rgb)))
    assert packed.dtype == np.uint16 and packed.shape == (2, 3, 5, 4)
    planar = packed.view(np.uint8).reshape(2, 3, 5, 8)
    np.testing.assert_array_equal(planar, rgb.transpose(0, 3, 1, 2))


def test_lane_block_not_multiple_of_program_width(monkeypatch):
    """Ten restart-segment lanes over programs of four: the third
    program is half padding lanes, and both emits stay exact."""
    monkeypatch.setattr(wp, "_pick_group", lambda n_lanes, g=4: 4)
    data = make_jpeg(80, 32, seed=12, subsampling=2, restart_blocks=1)
    jpeg = bitstream.parse(data)
    plan = wp.build_block_plan([jpeg])
    assert plan.n_lanes == 10 and plan.lane_group == 4 and plan.n_groups == 3
    comps, failures = wp.decode_batch_to_device([jpeg])
    assert not failures
    for a, b in zip(huffman.decode_all_scans(jpeg), comps[0]):
        np.testing.assert_array_equal(a, np.asarray(b))
    rgb, failures = wp.decode_batch_to_rgb([jpeg])
    assert not failures
    np.testing.assert_array_equal(np.asarray(rgb[0]), pil_decode(data))


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu(tmp_path):
    """On the CPU — in the checkout and alone in an empty directory —
    the smoke script exits non-zero and never reports success."""
    res = _run_smoke(REPO)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_bytes(open(os.path.join(REPO, "chip_smoke.py"), "rb").read())
    res = _run_smoke(str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_compile_cache_placement(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used exactly as given; without it the
    cache sits at a fixed path inside the checkout."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert tpujpeg.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert tpujpeg.compile_cache_dir() == os.path.join(REPO, ".jax_cache")


def test_native_library_keyed_on_host_cpu(monkeypatch):
    """A checkout copied to another machine must build its own -march=
    native library: the host CPU is part of the build key."""
    here = native_build._so_path()
    assert os.path.dirname(here) == os.path.dirname(native_build._SRC)
    monkeypatch.setattr(native_build, "host_cpu_key", lambda: "other-cpu")
    assert native_build._so_path() != here


@pytest.mark.gpu
def test_compiled_wavefront_matches_native(gpu):
    """The wavefront kernel as compiled for the GPU, both emits, against
    the native host decoder and PIL."""
    from tpujpeg.native import entropy as ne

    datas = [
        make_jpeg(256, 192, seed=s, subsampling=2, restart_blocks=4)
        for s in range(4)
    ]
    jpegs = [bitstream.parse(d) for d in datas]
    comps, failures = wp.decode_batch_to_device(jpegs)
    assert not failures
    for j, got in zip(jpegs, comps):
        for a, b in zip(ne.decode_all_scans(j), got):
            np.testing.assert_array_equal(a, np.asarray(b))
    rgb, failures = wp.decode_batch_to_rgb(jpegs)
    assert not failures
    for i, d in enumerate(datas):
        np.testing.assert_array_equal(np.asarray(rgb[i]), pil_decode(d))
