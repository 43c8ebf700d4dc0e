"""Mask compaction: variable-count FracMinHash survivors on a static-shape machine.

The reference GPU path writes survivors into fixed per-thread slot arrays and
silently drops overflow (reference:src/sketch_cuda.rs:136-138,
reference:src/cuda_kernel.cu:316). We instead compact exactly with a
cumsum + scatter into a capacity buffer and RETURN THE TRUE COUNT, so the
host can detect capacity overflow and retry with a larger cap — no silent
data loss.
"""

from __future__ import annotations

from typing import Tuple

import jax

import jax.numpy as jnp
import numpy as np

from hypergen_tpu.ops.u64 import U64


def compact_masked(h: U64, keep: jnp.ndarray, cap: int) -> Tuple[U64, jnp.ndarray]:
    """Gather kept entries of a flat hash vector into a [cap] buffer.

    h: U64 [..., P]; keep: bool [..., P]. Leading dims are treated as batch:
    compaction is per trailing axis. Returns (out: U64 [..., cap],
    count: int32 [...]) where out[..., :count] are the kept hashes in
    position order and the rest are zeros. If count > cap the first cap
    survivors are kept (caller must check count <= cap for exactness).
    """
    keep_i = keep.astype(jnp.int32)
    pos = jnp.cumsum(keep_i, axis=-1) - 1  # target slot for each kept entry
    idx = jnp.where(keep, pos, cap)  # out-of-bounds -> dropped
    batch_shape = h.lo.shape[:-1]
    out_hi = jnp.zeros(batch_shape + (cap,), dtype=jnp.uint32)
    out_lo = jnp.zeros(batch_shape + (cap,), dtype=jnp.uint32)
    # scatter along the last axis with drop semantics
    out_hi = _scatter_last(out_hi, idx, h.hi)
    out_lo = _scatter_last(out_lo, idx, h.lo)
    count = jnp.sum(keep_i, axis=-1)
    return U64(out_hi, out_lo), count


def _scatter_last(out: jnp.ndarray, idx: jnp.ndarray, val: jnp.ndarray) -> jnp.ndarray:
    if out.ndim == 1:
        return out.at[idx].set(val, mode="drop")
    # build full index grids for leading axes
    lead = jnp.indices(idx.shape, dtype=jnp.int32)[:-1]
    return out.at[tuple(lead) + (idx,)].set(val, mode="drop")


def block_extract(
    h: U64, keep: jnp.ndarray, block: int, slots: int,
    payload: jnp.ndarray = None,
) -> Tuple[U64, jnp.ndarray, jnp.ndarray]:
    """Scatter-free sparse compaction: masked-max slot extraction.

    No per-element scatter: FracMinHash survivors are sparse
    (~1/scaled). Split positions into blocks of `block`; each block holds at
    most `slots` survivors (with huge probability for block/scaled << slots —
    verified via the returned counts, never assumed). The s-th survivor of a
    block is extracted with a masked max-reduce — exactly one lane matches
    rank s, so max() IS selection, and everything stays dense elementwise work.

    h, keep: [..., P] with P % block == 0. Returns
      (out: U64 [..., nb*slots] — sentinel U64_MAX in empty slots,
       block_counts: int32 [..., nb],
       max_count: int32 [...] — caller checks <= slots for exactness).
    payload (optional): int32 [..., P] >= 0 values riding along with each
    survivor (e.g. its position); returned as a fourth output
    [..., nb*slots] with -1 in empty slots.
    """
    P = keep.shape[-1]
    if P % block != 0:
        raise ValueError(f"positions {P} not a multiple of block {block}")
    nb = P // block
    lead = keep.shape[:-1]
    keep_b = keep.reshape(lead + (nb, block))
    hi_b = h.hi.reshape(lead + (nb, block))
    lo_b = h.lo.reshape(lead + (nb, block))
    rank = jnp.cumsum(keep_b.astype(jnp.int32), axis=-1)  # 1-based at survivors
    counts = rank[..., -1]
    outs_hi = []
    outs_lo = []
    outs_pl = []
    if payload is not None:
        pl_b = payload.reshape(lead + (nb, block))
    for s in range(slots):
        sel = keep_b & (rank == (s + 1))
        outs_hi.append(jnp.max(jnp.where(sel, hi_b, 0), axis=-1))
        outs_lo.append(jnp.max(jnp.where(sel, lo_b, 0), axis=-1))
        if payload is not None:
            outs_pl.append(jnp.max(jnp.where(sel, pl_b, -1), axis=-1))
    out_hi = jnp.stack(outs_hi, axis=-1)  # [..., nb, slots]
    out_lo = jnp.stack(outs_lo, axis=-1)
    slot_idx = jax.lax.broadcasted_iota(jnp.int32, out_hi.shape, out_hi.ndim - 1)
    empty = slot_idx >= counts[..., None]
    sent = np.uint32(0xFFFFFFFF)
    out_hi = jnp.where(empty, sent, out_hi)
    out_lo = jnp.where(empty, sent, out_lo)
    max_count = jnp.max(counts, axis=-1)
    out = (
        U64(out_hi.reshape(lead + (nb * slots,)), out_lo.reshape(lead + (nb * slots,))),
        counts,
        max_count,
    )
    if payload is not None:
        return out + (jnp.stack(outs_pl, axis=-1).reshape(lead + (nb * slots,)),)
    return out
