"""The one place that decides which code path runs on which backend.

Every device-path choice in the package reads `caps()`, resolved once per
process from JAX's default backend:

  - hash_path: "packed" runs the fused Pallas sketch kernel
    (ops.pallas.hash_kernel); "xla" runs the unfused XLA step
    (ops.kmers). Both give bit-identical sketches.
  - dot_mode: the exact int16 dot of dist/search (ops.ani int8_split):
    False = one int32 dot_general; True = int8 splits on the tensor cores
    (upgraded per call to the 3-matmul "small" split when every value
    fits). All modes are exact integers, so outputs never depend on it.
  - interpret: Pallas kernels run in interpret mode. Only the GPU compiles
    them; anywhere else (the CPU test suite) a kernel that is asked for
    explicitly is interpreted.

The GPU choices were measured on an H100 SXM (700 W, PERF.md): the fused
kernel step 1.35 ms vs 6.52 ms for the XLA step at 8 x 4.19 Mbp, and the
int8 splits 2.7-3.4 ms vs 91 ms for the int32 dot at 49,152 x 2,048 x
4,096.

The CLI's -D flag (`select_platform` / `require_platform`) picks the
platform before the first backend touch and refuses to run a GPU request
anywhere else.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import sys
from typing import Optional, Union

import jax

log = logging.getLogger("hypergen")

# -D value -> JAX platform name
_PLATFORMS = {"gpu": "cuda", "cpu": "cpu"}


@dataclasses.dataclass(frozen=True)
class Caps:
    hash_path: str
    dot_mode: Union[bool, str]
    interpret: bool


@functools.lru_cache(maxsize=None)
def caps() -> Caps:
    if jax.default_backend() == "gpu":
        return Caps(hash_path="packed", dot_mode=True, interpret=False)
    return Caps(hash_path="xla", dot_mode=False, interpret=True)


def select_platform(device: Optional[str]) -> None:
    """Pin JAX to the -D platform; must run before the first backend
    touch. None keeps JAX's own choice."""
    if device is not None:
        jax.config.update("jax_platforms", _PLATFORMS[device])


def require_platform(device: Optional[str]) -> None:
    """Exit non-zero unless the -D platform really is the one in use: a
    run that asked for the GPU never carries on elsewhere."""
    if device is None:
        return
    try:
        platform = jax.devices()[0].platform
    except Exception as e:  # JAX raises RuntimeError or AssertionError
        log.error("-D %s: no %s device available (%r)", device,
                  _PLATFORMS[device], e)
        sys.exit(2)
    if platform != device:
        log.error("-D %s: JAX runs on %s instead", device, platform)
        sys.exit(2)
