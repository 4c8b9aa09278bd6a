"""DecodeConfig: the single knob surface (SURVEY.md §5 "Config / flag
system"). Everything is defaulted so `tpujpeg.decode(data)` just works."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    # Entropy stage of the staged path: 'auto' picks native C when
    # available, falling back to the pure-Python oracle; 'wavefront' is
    # the device kernel. (On the GPU, decode() first tries the fused
    # single-dispatch chain — see decoder.decode.)
    entropy_engine: str = "auto"  # 'auto' | 'python' | 'native' | 'wavefront'

    # IDCT variant: 'islow' is bit-exact vs libjpeg; 'matmul' is one
    # float32 matrix product per block (libjpeg-conformant tolerance).
    idct: str = "islow"  # 'islow' | 'matmul'

    # libjpeg do_fancy_upsampling equivalent (default on, like libjpeg).
    fancy_upsampling: bool = True

    # Wavefront decoder lane count per kernel launch (SURVEY.md §7.2 #1).
    wavefront_lanes: int = 1024

    # Return numpy instead of jax.Array from decode().
    to_numpy: bool = True

    # Mesh axis name used by batched / sharded decode paths.
    mesh_axis: str = "data"


DEFAULT_CONFIG = DecodeConfig()
