"""ANI estimation as dense HV matmuls (replaces the reference's pair loop).

The reference computes each pair's dot product in a rayon thread loop
(reference:src/dist.rs:267-291). On a device the entire n_ref x n_query
dot matrix is ONE matmul. Exactness: the reference accumulates i16*i16
products into i32 with wrapping (reference:src/dist.rs:146-151); we
preserve that bit-exactly either with a direct int32 dot_general (CPU
backend) or with a 4-way int8-split (int8 tensor-core GEMMs on the GPU):

    v = 256*hi + (lo - 128) + 128,  hi = v >> 8 in [-128,127],
                                    lo = (v & 0xFF) - 128 in [-128,127]
    dot(r, q) = 65536*HH + 256*(HL + LH) + LL
              + 32768*(sum(RH) + sum(QH)) + 128*(sum(RL) + sum(QL)) + 16384*D

All four matmuls are int8 x int8 -> int32; the splits are
value-preserving casts, so every downstream wrap is congruent mod 2^32 to
the reference's wrapping i32 accumulation. (A naive sign-extended-low-byte
split would need hi=128 for v in [32640, 32767], which int8 cannot hold.)

The scalar dot -> Jaccard -> ANI map follows reference:src/dist.rs:150-161
in float32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class SmallSplit(NamedTuple):
    """A resident operand pre-split for the 3-matmul "small" mode: int8
    planes h, l and their (int8-exact) sum — one int8 matmul fewer than the
    4-way split AND no per-query r-side elementwise work. Only valid when
    the operand passed the |v| <= SMALL_SPLIT_MAX check (caller-enforced,
    see presplit_rows_small)."""

    h: jnp.ndarray
    l: jnp.ndarray
    hl: jnp.ndarray


def split_i16_to_i8(x: jnp.ndarray):
    """x == 256*hi + (lo + 128); hi, lo both exactly representable in int8."""
    x32 = x.astype(jnp.int32)
    hi = (x32 >> 8).astype(jnp.int8)  # arithmetic shift: [-128, 127]
    lo = ((x32 & 0xFF) - 128).astype(jnp.int8)  # [-128, 127]
    return hi, lo


# |values| up to this bound admit the 3-matmul Karatsuba split below:
# v = 64*h + l with l = ((v+32) & 63) - 32 in [-32, 31] and
# h = (v+32) >> 6 in [-96, 96], so h, l, AND h+l all fit int8.
# (At 6176, h+l would need 128.) HVs stay well under this for genomes up to
# ~9 Mbp at scaled=1500 (|hv| <= n_hashes); callers verify per DB.
SMALL_SPLIT_MAX = 6175


def abs_bound(a: np.ndarray) -> int:
    """max |value| of an int array via min/max reductions — no temporaries
    (np.abs(a.astype(int32)) allocates ~2x the array and measured ~58 s at
    GTDB scale), and python-int conversion sidesteps the int16 -32768
    negation wrap."""
    a = np.asarray(a)
    return max(int(a.max()), -int(a.min())) if a.size else 0


def _split_small(x: jnp.ndarray):
    x32 = x.astype(jnp.int32)
    h = ((x32 + 32) >> 6).astype(jnp.int8)
    l = (((x32 + 32) & 63) - 32).astype(jnp.int8)
    return h, l


def presplit_rows(r: jnp.ndarray):
    """Precompute a resident operand's int8 planes + row correction.

    The int16->int8 splitting is elementwise over the full operand and
    is elementwise work outside the matmuls; for a device-resident DB reused
    across many query tiles it should happen ONCE. Returns
    (hi int8 [M, D], lo int8 [M, D], row int32 [M]) consumed by
    dot_i16_presplit. Same bytes as the int16 original.
    """
    rh, rl = split_i16_to_i8(r)
    # row correction of the 4-way split: 32768*sum(rh) + 128*sum(rl)
    row = (jnp.sum(rh.astype(jnp.int32), axis=-1) << 15) + (
        jnp.sum(rl.astype(jnp.int32), axis=-1) << 7
    )
    return rh, rl, row


def presplit_rows_small(r: jnp.ndarray) -> SmallSplit:
    """Precompute a resident operand's 3-matmul "small" planes.

    Caller must have verified abs_bound(r) <= SMALL_SPLIT_MAX. Same bytes
    as the int16 original; h, l AND h+l all fit int8 by the bound."""
    h, l = _split_small(r)
    return SmallSplit(h, l, h + l)


def dot_i16_presplit_small(r: SmallSplit, q: jnp.ndarray) -> jnp.ndarray:
    """3-matmul exact dot with the r side pre-split by presplit_rows_small.

    q must also satisfy |q| <= SMALL_SPLIT_MAX (callers route here only
    after checking both sides, mirroring _resolve_split)."""
    qh, ql = _split_small(q)

    def d(a, b):
        return jax.lax.dot_general(
            a, b,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )

    hh = d(r.h, qh)
    ll = d(r.l, ql)
    mm = d(r.hl, qh + ql)
    return (hh << 12) + ((mm - hh - ll) << 6) + ll


def dot_i16_presplit(
    rh: jnp.ndarray, rl: jnp.ndarray, row: jnp.ndarray, q: jnp.ndarray
) -> jnp.ndarray:
    """4-way-split exact dot with the r side pre-split by presplit_rows."""
    D = q.shape[-1]
    qh, ql = split_i16_to_i8(q)

    def d(a, b):
        return jax.lax.dot_general(
            a, b,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )

    hh = d(rh, qh)
    hl = d(rh, ql)
    lh = d(rl, qh)
    ll = d(rl, ql)
    s32 = lambda a: jnp.sum(a.astype(jnp.int32), axis=-1)
    col = (s32(qh) << 15) + (s32(ql) << 7)
    const = jnp.int32(((16384 * D + (1 << 31)) % (1 << 32)) - (1 << 31))
    return (
        (hh << 16)
        + ((hl + lh) << 8)
        + ll
        + row[:, None]
        + col[None, :]
        + const
    )


def dot_i16_exact(r: jnp.ndarray, q: jnp.ndarray, int8_split=True) -> jnp.ndarray:
    """Int32 [M, N] dot matrix of int16 HVs r [M, D], q [N, D].

    Bit-exact (mod 2^32) vs. the reference's wrapping i32 accumulation.
    int8_split: False = direct int32 dot_general (CPU); True = 4-way int8
    split (any int16 values); "small" = 3-matmul Karatsuba int8 split —
    25% fewer int8 matmuls, valid ONLY when every |value| <= SMALL_SPLIT_MAX
    (caller-checked):  dot = 4096*HH + 64*(MM - HH - LL) + LL with
    M = H + L, all three operand planes int8. Wrapping int32 combination
    keeps the mod-2^32 congruence.
    """
    if int8_split == "small":
        rh, rl = _split_small(r)
        qh, ql = _split_small(q)

        def d(a, b):
            return jax.lax.dot_general(
                a, b,
                dimension_numbers=(((1,), (1,)), ((), ())),
                preferred_element_type=jnp.int32,
            )

        hh = d(rh, qh)
        ll = d(rl, ql)
        mm = d(rh + rl, qh + ql)
        return (hh << 12) + ((mm - hh - ll) << 6) + ll
    if int8_split:
        # one home for the 4-way split + mod-2^32 correction math: split
        # the r side via presplit_rows and reuse the presplit combine
        return dot_i16_presplit(*presplit_rows(r), q)
    return jax.lax.dot_general(
        r.astype(jnp.int32),
        q.astype(jnp.int32),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def ani_from_dot_matrix(
    dot: jnp.ndarray,
    norm2_r: jnp.ndarray,
    norm2_q: jnp.ndarray,
    ksize: int,
) -> jnp.ndarray:
    """float32 ANI%% matrix (reference:src/dist.rs:150-161).

    dot: int32 [M, N]; norm2_r: int32 [M]; norm2_q: int32 [N].
    NaN -> 0, clamp to [0, 1] * 100.

    NOTE: XLA may algebraically rewrite the float32 chain, so this can
    deviate from the reference's scalar f32 evaluation by O(1e-4) ANI%%.
    Fine for search/ranking; the TSV output path instead computes the dot
    matrix on device and applies the host-side float32 map
    (oracle.pipeline.ani_from_dot semantics) for closest-to-reference
    rounding at the 3-decimal print boundary.
    """
    dot_f = dot.astype(jnp.float32)
    denom = (norm2_r[:, None] + norm2_q[None, :] - dot).astype(jnp.float32)
    jaccard = dot_f / denom
    inner = jnp.float32(2.0) / (jnp.float32(1.0) / jaccard + jnp.float32(1.0))
    ani = jnp.float32(1.0) + jnp.log(inner) / jnp.float32(ksize)
    ani = jnp.where(jnp.isnan(ani), jnp.float32(0.0), ani)
    ani = jnp.clip(ani, jnp.float32(0.0), jnp.float32(1.0))
    return ani * jnp.float32(100.0)


@functools.partial(jax.jit, static_argnames=("int8_split",))
def dot_i16_any(r, q: jnp.ndarray, int8_split=True) -> jnp.ndarray:
    """dot_i16_exact that also accepts a presplit r: a SmallSplit (3-matmul
    resident planes) or a (hi, lo, row) 4-way-split tuple.

    A SmallSplit r with int8_split != "small" (a rare over-bound query batch
    against a small-resident DB) rebuilds the exact int16 rows on device
    (x = 64*h + l, lossless by construction of _split_small) and takes the
    requested mode — correctness never depends on the resident layout."""
    if isinstance(r, SmallSplit):
        if int8_split == "small":
            return dot_i16_presplit_small(r, q)
        x = (
            64 * r.h.astype(jnp.int32) + r.l.astype(jnp.int32)
        ).astype(jnp.int16)
        return dot_i16_exact(x, q, int8_split=int8_split)
    if isinstance(r, tuple):
        return dot_i16_presplit(*r, q)
    return dot_i16_exact(r, q, int8_split=int8_split)


@functools.partial(jax.jit, static_argnames=("ksize", "int8_split"))
def ani_matrix(
    r_hv: jnp.ndarray,
    norm2_r: jnp.ndarray,
    q_hv: jnp.ndarray,
    norm2_q: jnp.ndarray,
    ksize: int,
    int8_split: bool = True,
) -> jnp.ndarray:
    """Full [M, N] ANI%% matrix from int16 HVs (r_hv may be presplit)."""
    dot = dot_i16_any(r_hv, q_hv, int8_split=int8_split)
    return ani_from_dot_matrix(dot, norm2_r, norm2_q, ksize)


@functools.partial(jax.jit, static_argnames=("ksize", "k_top", "int8_split"))
def ani_topk(
    r_hv: jnp.ndarray,
    norm2_r: jnp.ndarray,
    q_hv: jnp.ndarray,
    norm2_q: jnp.ndarray,
    ksize: int,
    k_top: int,
    int8_split: bool = True,
):
    """Per-query top-k (ANI, ref index, exact dot) — the `search` primitive.

    Returns (ani [N, k_top] float32, idx [N, k_top] int32, dot [N, k_top]
    int32) where rows are queries. The int32 dots are exact (mod 2^32);
    the TSV path recomputes ANI from them with the host float chain so
    `search` rows print byte-identically to `dist` rows for the same pair.
    The reference's `search` subcommand is an unimplemented stub
    (reference:src/main.rs:22-24); this realizes it as dist-with-top-k.
    """
    dot = dot_i16_any(r_hv, q_hv, int8_split=int8_split)  # [M, N] exact int32
    ani = ani_from_dot_matrix(dot, norm2_r, norm2_q, ksize)
    vals, idx = jax.lax.top_k(ani.T, k_top)  # [N, k_top]
    dots = jnp.take_along_axis(dot.T, idx, axis=1)
    return vals, idx.astype(jnp.int32), dots


@functools.partial(jax.jit, static_argnames=("ksize", "cap", "int8_split"))
def dot_threshold_compact(
    r_hv: jnp.ndarray,
    norm2_r: jnp.ndarray,
    q_hv: jnp.ndarray,
    norm2_q: jnp.ndarray,
    threshold: jnp.ndarray,
    ksize: int,
    cap: int,
    int8_split: bool = True,
):
    """Dot tile + ANI-threshold filter + compaction, all on device.

    The `dist` workload at production thresholds (>=85%) keeps well under 1%
    of pairs, so fetching the full int32 dot tile (4 bytes/pair) wastes
    nearly all D2H bandwidth. This computes the [M, N] tile, filters by a
    margin-relaxed float32 ANI test, and compacts survivors; only
    (count, flat index, exact int32 dot) x cap leave the device. Callers
    recompute the reference-exact float chain from the exact dots on host
    and re-filter, so the final TSV is byte-identical to the full-fetch
    path (the 0.01%% margin covers any XLA-vs-host f32 drift, which is
    O(1e-4), see ani_from_dot_matrix).

    Returns (count int32 scalar — caller retries with larger cap if
    count > cap, flat_idx int32 [cap] (-1 padding), dot int32 [cap]).
    r_hv may be a presplit (hi, lo, row) tuple from presplit_rows.
    """
    dot = dot_i16_any(r_hv, q_hv, int8_split=int8_split)
    ani = ani_from_dot_matrix(dot, norm2_r, norm2_q, ksize)
    keep = ani >= (threshold.astype(jnp.float32) - jnp.float32(0.01))
    M, N = dot.shape
    flat_keep = keep.reshape(-1)
    flat_dot = dot.reshape(-1)
    pos = jnp.cumsum(flat_keep.astype(jnp.int32)) - 1
    slot = jnp.where(flat_keep, pos, cap)  # out-of-bounds -> dropped
    out_dot = jnp.zeros((cap,), jnp.int32).at[slot].set(flat_dot, mode="drop")
    out_idx = jnp.full((cap,), -1, jnp.int32).at[slot].set(
        jnp.arange(M * N, dtype=jnp.int32), mode="drop"
    )
    return jnp.sum(flat_keep.astype(jnp.int32)), out_idx, out_dot
