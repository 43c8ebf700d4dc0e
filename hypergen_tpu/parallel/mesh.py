"""Device mesh construction and multi-host initialization."""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

log = logging.getLogger("hypergen")

AXIS_DB = "db"
AXIS_Q = "q"


def make_mesh(
    n_db: Optional[int] = None,
    n_q: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A (db, q) mesh over the available devices.

    Defaults: all devices on the ``db`` axis (DB sharding scales memory,
    which is the binding constraint for GTDB-scale databases), ``q`` = 1.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_db is None and n_q is None:
        n_db, n_q = n, 1
    elif n_db is None:
        n_db = n // n_q
    elif n_q is None:
        n_q = n // n_db
    if n_db * n_q != n:
        raise ValueError(f"mesh {n_db}x{n_q} != {n} devices")
    arr = np.asarray(devices).reshape(n_db, n_q)
    return Mesh(arr, (AXIS_DB, AXIS_Q))


def init_distributed(coordinator: str = "", num_processes: int = 0,
                     process_id: int = 0) -> None:
    """Explicit multi-host init (no-op when num_processes <= 1)."""
    if num_processes and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator or None,
            num_processes=num_processes,
            process_id=process_id,
        )
        log.info(
            "jax.distributed initialized: process %d/%d, %d local / %d global devices",
            process_id, num_processes,
            jax.local_device_count(), jax.device_count(),
        )


def maybe_init_distributed() -> None:
    """Env-driven multi-host init for the CLI entry point.

    Every pod branch in the CLI gates on jax.process_count() > 1, which is
    only ever true after jax.distributed.initialize — someone must CALL it,
    so the CLI invokes this before the first backend touch. Opt-in:

      HG_NUM_PROCESSES=N HG_PROCESS_ID=i HG_COORDINATOR=host:port  explicit
      HG_DIST=1   jax.distributed.initialize() environment auto-detection
                  (cluster launchers such as SLURM set the required
                  variables)

    No-op otherwise: single-host runs must not pay a coordinator wait."""
    import os

    n = int(os.environ.get("HG_NUM_PROCESSES", "0") or 0)
    if n > 1:
        init_distributed(
            os.environ.get("HG_COORDINATOR", ""), n,
            int(os.environ.get("HG_PROCESS_ID", "0") or 0),
        )
    elif os.environ.get("HG_DIST", "").lower() in ("1", "auto", "true"):
        jax.distributed.initialize()
        log.info(
            "jax.distributed auto-initialized: process %d/%d",
            jax.process_index(), jax.process_count(),
        )


def shared_run_token() -> str:
    """A random token agreed by all processes (broadcast from process 0).

    Used to tag per-host part files so a merge never picks up stale parts
    left by a previous crashed run in the same output directory.
    """
    import os

    if jax.process_count() == 1:
        return os.urandom(8).hex()
    from jax.experimental import multihost_utils

    # two u32 words, NOT one u64: with jax x64 disabled, canonicalization
    # inside broadcast_one_to_all would silently truncate a uint64 payload
    # to 32 bits of entropy
    local = np.frombuffer(os.urandom(8), dtype=np.uint32).copy()
    tok = multihost_utils.broadcast_one_to_all(local)
    return np.asarray(tok, dtype=np.uint32).tobytes().hex()
