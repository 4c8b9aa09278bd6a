"""The one decision about how this process runs its Pallas kernels.

Every kernel call site, the fused single-dispatch switch in `decode()`
and the lane sizing of the wavefront plans ask `pallas_interpret()`:

  gpu   kernels compile through Pallas' Triton route (the device path)
  cpu   kernels run in Pallas interpret mode (the documented test path)
  else  unsupported: raise, naming the platform
"""

from __future__ import annotations

from typing import Optional

import jax


def pallas_interpret(platform: Optional[str] = None) -> bool:
    """False when Pallas kernels compile for the device (GPU), True when
    they run in interpret mode (CPU). `platform` defaults to JAX's
    default backend; any platform but 'gpu' and 'cpu' raises."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return False
    if platform == "cpu":
        return True
    raise RuntimeError(
        f"tpujpeg runs its kernels on 'gpu' (compiled) or 'cpu' "
        f"(interpret mode); JAX platform {platform!r} is not supported"
    )
