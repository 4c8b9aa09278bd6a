"""tpujpeg — a JPEG decode engine whose hot path runs on the GPU.

Brand-new JAX/XLA/Pallas implementation with the capability surface of
xinfushe/oclJPEGDecoder's OpenCL pipeline (see SURVEY.md; the reference
checkout is an empty mount, so the capability contract is BASELINE.json's
north star + ITU-T T.81, validated bit-exactly against libjpeg/PIL).

Public API:
    decode(data: bytes) -> np.ndarray        # one image
    decode_file(path) -> np.ndarray
    decode_batch(list[bytes]) -> list        # batched, fault-isolated
    DecodeConfig, DecodeStats, JpegError
"""

import os as _os

import jax as _jax


def compile_cache_dir() -> str:
    """Where the persistent XLA compilation cache lives: exactly
    JAX_COMPILATION_CACHE_DIR when it is set, otherwise the fixed,
    gitignored `.jax_cache` directory at the root of the checkout (a
    fixed path, because the path is part of the cache's key)."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


# Persistent XLA compilation cache: decode geometries recompile per
# process otherwise (SURVEY.md §2.2 #21 — kernel compilation is a
# first-class runtime component). Opt out with TPUJPEG_NO_COMPILE_CACHE=1.
if not _os.environ.get("TPUJPEG_NO_COMPILE_CACHE"):
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
    # Cache EVERY compile: the test suite's fault-injection and
    # multi-geometry cases trip hundreds of sub-second CPU compiles
    # that a min-compile-time threshold silently recompiles every
    # process.
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

from .config import DEFAULT_CONFIG, DecodeConfig
from .decoder import decode, decode_file
from .errors import (
    JpegError,
    JpegHuffmanError,
    JpegSyntaxError,
    JpegTruncatedError,
    JpegUnsupportedError,
)
from .stats import DecodeStats

__version__ = "0.1.0"

__all__ = [
    "compile_cache_dir",
    "decode",
    "decode_file",
    "DecodeConfig",
    "DEFAULT_CONFIG",
    "DecodeStats",
    "JpegError",
    "JpegSyntaxError",
    "JpegUnsupportedError",
    "JpegTruncatedError",
    "JpegHuffmanError",
    "__version__",
]


def decode_batch(datas, config=DEFAULT_CONFIG, **kw):
    """Batched decode with per-image fault isolation (lazy import to keep
    the base import light)."""
    from .parallel import batch as _batch

    return _batch.decode_batch(datas, config, **kw)


def decode_batch_on_device(datas, config=DEFAULT_CONFIG):
    """Full on-device batched decode: one fused wavefront entropy + IDCT
    launch per geometry bucket, progressive groups through the scan
    kernels; coefficients never touch the host."""
    from .parallel import batch as _batch

    return _batch.decode_batch_on_device(datas, config)


def decode_stream(datas, config=DEFAULT_CONFIG, **kw):
    """Pipelined chunked decode: host prep on worker threads overlapped
    with fused on-device decode, `depth` chunks in flight (SURVEY.md
    §2.3 PP row). Yields StreamChunk per chunk_size images, in order."""
    from .parallel import stream as _stream

    return _stream.decode_stream(datas, config, **kw)


def decode_batch_pipelined(datas, config=DEFAULT_CONFIG, **kw):
    """decode_batch_on_device semantics via the overlapped pipeline."""
    from .parallel import stream as _stream

    return _stream.decode_batch_pipelined(datas, config, **kw)
