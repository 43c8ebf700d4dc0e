"""Fused sketch front half as one Pallas kernel for Hopper (Triton route).

The XLA formulation (ops.kmers via models.sketcher's unfused step) writes a
byte per base, stacked chunk copies with k-1 halos, and a hash and keep
mask for every position to device memory. This kernel reads the genome as
packed 2-bit words and writes only the FracMinHash survivors:

  - every cell owns a contiguous run of lsub k-mer starts (+ a k-1 halo)
    and is one GPU thread, the decomposition of the reference CUDA kernel
    (reference:src/cuda_kernel.cu:29-40); cells form power-of-two blocks
    (one program per block);
  - a loop walks the cell's positions one base per step, carrying the
    rolling state in registers: 2-bit fwd/rc k-mers (canonical strand by
    numeric compare, equivalent to bytewise strcmp for ACGT), and the
    little-endian ASCII byte windows of both strands (the exact t1ha2
    input layout);
  - t1ha2 runs on u64-as-2xu32 pairs (ops.hashes), the same math as the
    XLA path;
  - survivors fill `cap` per-cell register slots with their chunk-local
    position, written once at the end. The true count is emitted as well,
    so slot overflow is detected and retried by the caller, never dropped.

Invalid bases are not read: every position is hashed optimistically and
the caller repairs false survivors exactly with its sparse invalid-run
postfilter (models.sketcher.filter_positions_by_runs).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from hypergen_tpu.ops import u64 as u
from hypergen_tpu.ops.hashes import mm_hash64, t1ha2_atonce_words
from hypergen_tpu.ops.kmers import _ascii_from_code
from hypergen_tpu.ops.u64 import U64

# cells per program: one thread per cell at BLOCK // 32 warps
BLOCK = 128
_SENT = np.uint32(0xFFFFFFFF)


def _roll_window(st, cb, *, ksize, method):
    """Window-maintenance half of one rolling step: shift the incoming base
    into the 2-bit fwd/rc keys and (t1ha2) the ASCII byte windows. No hash —
    the k-1 warm-up positions per cell need only this (~1/6 the ops of the
    full step), so the kernel runs it bare until the first full window.

    st = (f2, r2, fw, rw): 2-bit fwd/rc keys (U64) + fwd/rc ASCII u32
    words. cb: uint32 2-bit base code of the incoming position (one per
    cell). Returns st'.
    """
    k = ksize
    n_u32 = (k + 3) // 4
    top_word_mask = np.uint32((1 << (8 * (k - 4 * (n_u32 - 1)))) - 1)
    kmer_mask = (1 << (2 * k)) - 1  # rolling fwd shifts in stale high bits
    kmer_hi_mask = np.uint32(kmer_mask >> 32)
    kmer_lo_mask = np.uint32(kmer_mask & 0xFFFFFFFF)
    # position of the newest fwd byte within its u32 word
    new_q, new_s = divmod(k - 1, 4)
    # shift placing the newest rc 2-bit base at bit 2k-2 of the (hi, lo) pair
    rc_shift = 2 * k - 2

    f2, r2, fw, rw = st
    # rolling 2-bit k-mers (first base most significant)
    f2 = u.shl(f2, 2)
    f2 = U64(f2.hi & kmer_hi_mask, (f2.lo & kmer_lo_mask) | cb)
    comp = np.uint32(3) - cb
    r2 = u.shr(r2, 2)
    if rc_shift >= 32:
        r2 = U64(r2.hi | (comp << np.uint32(rc_shift - 32)), r2.lo)
    else:
        r2 = U64(r2.hi, r2.lo | (comp << np.uint32(rc_shift)))

    if method == "t1ha2":
        a_f = _ascii_from_code(cb)
        a_r = _ascii_from_code(comp)
        # fwd ASCII window: bytes shift toward index 0, newest at k-1
        nfw = []
        for q in range(n_u32):
            w = fw[q] >> 8
            if q + 1 < n_u32:
                w = w | ((fw[q + 1] & np.uint32(0xFF)) << 24)
            nfw.append(w)
        nfw[new_q] = nfw[new_q] | (a_f << np.uint32(8 * new_s))
        # rc ASCII window: bytes shift toward higher index, newest at 0
        nrw = []
        for q in range(n_u32):
            w = rw[q] << 8
            if q > 0:
                w = w | (rw[q - 1] >> 24)
            nrw.append(w)
        nrw[0] = nrw[0] | a_r
        nrw[n_u32 - 1] = nrw[n_u32 - 1] & top_word_mask
        fw, rw = nfw, nrw
    return (f2, r2, fw, rw)


def _hash_window(st, shape, *, ksize, seed, canonical, method):
    """Hash half of one rolling step: canonical-strand select + t1ha2 (or
    mmhash) over the current full window. `shape` is the cell tile shape
    (for the non-canonical zero mask)."""
    k = ksize
    n_u32 = (k + 3) // 4
    n_words = (k + 7) // 8
    f2, r2, fw, rw = st

    if canonical:
        is_rc = u.lt(r2, f2)
    else:
        is_rc = jnp.zeros(shape, dtype=bool)

    if method == "t1ha2":
        zero = jnp.zeros(shape, dtype=jnp.uint32)
        sel = [jnp.where(is_rc, rw[q], fw[q]) for q in range(n_u32)]
        words = []
        for wq in range(n_words):
            lo = sel[2 * wq]
            hi = sel[2 * wq + 1] if 2 * wq + 1 < n_u32 else zero
            words.append(U64(hi, lo))
        h = t1ha2_atonce_words(words, k, seed)
    else:  # mmhash on the canonical 2-bit key
        key = u.select(is_rc, r2, f2) if canonical else f2
        h = mm_hash64(key)
    return h


def _advance_hash(st, cb, *, ksize, seed, canonical, method):
    """One full rolling-window step (the parity-critical t1ha2/mmhash
    window math exists exactly once): locals in, locals out. Returns
    (st', h)."""
    st = _roll_window(st, cb, ksize=ksize, method=method)
    h = _hash_window(
        st, cb.shape, ksize=ksize, seed=seed, canonical=canonical,
        method=method,
    )
    return st, h


def _packed_kernel(pos_end_ref, words_ref, slot_hi_ref, slot_lo_ref,
                   slot_pos_ref, cnt_ref, *, ksize, seed, threshold,
                   canonical, method, lsub, cells, n_chunks, row_words, cap,
                   unroll):
    """One program = BLOCK cells of one chunk; one cell per thread.

    words_ref: u32 [B * row_words] flat packed rows (16 bases per word).
    pos_end_ref: i32 [B * n_chunks] k-mer starts per chunk (positions at or
    past it are the padding tail and never survive).
    Outputs are flat [B * n_chunks * cap * cells] slot planes and the
    per-cell survivor count [B * n_chunks * cells].
    """
    k = ksize
    n_u32 = (k + 3) // 4
    lw = lsub // 16
    bpc = cells // BLOCK
    pid = pl.program_id(0)
    chunk = pid // bpc  # row * n_chunks + chunk index within the row
    blk = pid - chunk * bpc
    row = chunk // n_chunks
    ci = chunk - row * n_chunks
    cell = blk * BLOCK + jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)
    # each cell reads its own words directly: [word0, word0 + T_w)
    word0 = row * row_words + ci * (cells * lw) + cell * lw
    pos_end = pos_end_ref[chunk]
    cell_base = cell * lsub

    def fetch(t):
        w = words_ref[word0 + (t >> 4)]
        return (w >> ((t & 15) * 2).astype(jnp.uint32)) & np.uint32(3)

    def emit(h, t, slots, cnt):
        # t >= k-1 always holds here: warm-up positions never reach emit
        pos = cell_base + (t - (k - 1))
        keep = u.lt_const(h, threshold) & (pos < pos_end)
        s_hi, s_lo, s_pos = slots
        for s in range(cap):
            put = keep & (cnt == s)
            s_hi[s] = jnp.where(put, h.hi, s_hi[s])
            s_lo[s] = jnp.where(put, h.lo, s_lo[s])
            s_pos[s] = jnp.where(put, pos, s_pos[s])
        return (s_hi, s_lo, s_pos), cnt + keep.astype(jnp.int32)

    z = jnp.zeros((BLOCK,), jnp.uint32)
    st = (U64(z, z), U64(z, z), [z] * n_u32, [z] * n_u32)

    # warm-up: the first k-1 positions only fill the window (roll, no hash)
    def warm_body(t, st):
        return _roll_window(st, fetch(t), ksize=ksize, method=method)

    st = jax.lax.fori_loop(0, k - 1, warm_body, st)

    # main loop: lsub full positions, every one of which may emit
    def steps(carry, t0, n):
        st, slots, cnt = carry
        for j in range(n):
            t = t0 + j
            st, h = _advance_hash(
                st, fetch(t), ksize=ksize, seed=seed, canonical=canonical,
                method=method,
            )
            slots, cnt = emit(h, t, slots, cnt)
        return st, slots, cnt

    slots = (
        [jnp.full((BLOCK,), _SENT, jnp.uint32)] * cap,
        [jnp.full((BLOCK,), _SENT, jnp.uint32)] * cap,
        [jnp.full((BLOCK,), -1, jnp.int32)] * cap,
    )
    cnt = jnp.zeros((BLOCK,), jnp.int32)
    carry = jax.lax.fori_loop(
        0, lsub // unroll,
        lambda i, c: steps(c, (k - 1) + i * unroll, unroll),
        (st, slots, cnt),
    )
    # tail of lsub % unroll positions (t kept traced, like the loop's)
    tail = lsub % unroll
    _, (s_hi, s_lo, s_pos), cnt = steps(
        carry, jnp.int32(k - 1 + lsub - tail), tail
    )
    for s in range(cap):
        out = (chunk * cap + s) * cells + cell
        slot_hi_ref[out] = s_hi[s]
        slot_lo_ref[out] = s_lo[s]
        slot_pos_ref[out] = s_pos[s]
    cnt_ref[chunk * cells + cell] = cnt


def packed_cells(chunk_positions: int) -> int:
    """Cells per chunk for the packed kernel (lsub = C / cells k-mer starts
    per thread), 0 when C does not fit the kernel's layout.

    lsub is a multiple of 16 (whole packed words per cell) and the cell
    count a multiple of BLOCK. lsub = 64 is preferred: the k-1 warm-up is
    re-done by every cell (24% of the steps at k=21), and at the
    production bucket (B=8 x 32 chunks of 2^17) it still launches 512k
    threads — about two waves of 132 SMs at full occupancy. Outputs are
    bit-identical for every legal value."""
    for lsub in (64, 128, 32, 16):
        cells, rem = divmod(chunk_positions, lsub)
        if rem == 0 and cells >= BLOCK and cells % BLOCK == 0:
            return cells
    return 0


@functools.partial(
    jax.jit,
    static_argnames=("n_chunks", "chunk_positions", "ksize", "seed",
                     "threshold", "canonical", "method", "interpret", "cells",
                     "cap", "unroll"),
)
def hash_packed_rows(
    packed_words: jnp.ndarray,
    n_pos: jnp.ndarray,
    n_chunks: int,
    chunk_positions: int,
    ksize: int,
    seed: int,
    threshold: int,
    canonical: bool = True,
    method: str = "t1ha2",
    interpret: bool = False,
    cells: int = 0,
    cap: int = 4,
    unroll: int = 0,
):
    """Fused front half of the sketch step straight from packed rows.

    packed_words: u32 [B, W] — per-genome 2-bit base codes, 16 per word
      (position p at bits [2*(p%16), +2) of word p//16). Rows must cover
      n_chunks*chunk_positions positions plus the last cell's halo words
      (invalid / padding regions may hold arbitrary bits).
    n_pos: i32 [B] — k-mer positions per genome; positions >= n_pos are
      masked in-kernel (everything below is postfiltered by the caller
      against the genome's invalid-run list).
    cells: cells per chunk (0 = packed_cells(chunk_positions)).

    Returns (h: U64 [B, S], pos: i32 [B, S] genome-global k-mer start,
    valid: bool [B, S], cell_max: i32 [B]) with S = n_chunks*cap*cells in
    [chunk, slot, cell] order. Empty slots carry the U64_MAX sentinel /
    pos -1. cell_max > cap means slot overflow: retry with a larger cap
    (exactness is never traded).

    unroll: positions per main-loop trip (0 = auto: 4 on the GPU, 1 in
    interpret mode, where a fatter trace only slows the tests); a
    remainder of lsub % unroll runs as a tail after the loop. Pure
    scheduling — outputs are bit-identical for every value.
    """
    B, W = packed_words.shape
    C = chunk_positions
    cells = cells or packed_cells(C)
    if not cells or cells % BLOCK or C % cells or (C // cells) % 16:
        raise ValueError(
            f"chunk positions {C} / cells {cells}: need cells a multiple of "
            f"{BLOCK} and C/cells a multiple of 16"
        )
    lsub = C // cells
    if unroll == 0:
        unroll = 1 if interpret else 4
    T_w = -(-(lsub + ksize - 1) // 16)
    iw, lw = C // 16, lsub // 16
    if W < n_chunks * iw + T_w - lw:
        raise ValueError(
            f"packed row too short: {W} words < {n_chunks * iw + T_w - lw}"
        )
    pos_end = jnp.clip(
        n_pos[:, None] - np.arange(n_chunks, dtype=np.int32)[None, :] * C,
        0, C,
    ).reshape(B * n_chunks).astype(jnp.int32)

    kern = functools.partial(
        _packed_kernel,
        ksize=ksize, seed=seed, threshold=threshold, canonical=canonical,
        method=method, lsub=lsub, cells=cells, n_chunks=n_chunks,
        row_words=W, cap=cap, unroll=unroll,
    )
    BN = B * n_chunks
    S = n_chunks * cap * cells
    slot_hi, slot_lo, slot_pos, cnt = pl.pallas_call(
        kern,
        grid=(BN * (cells // BLOCK),),
        out_shape=[
            jax.ShapeDtypeStruct((B * S,), jnp.uint32),
            jax.ShapeDtypeStruct((B * S,), jnp.uint32),
            jax.ShapeDtypeStruct((B * S,), jnp.int32),
            jax.ShapeDtypeStruct((BN * cells,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=BLOCK // 32, num_stages=1
        ),
        interpret=interpret,
        name="hg_packed_sketch",
    )(pos_end, packed_words.reshape(B * W))

    h = U64(slot_hi.reshape(B, S), slot_lo.reshape(B, S))
    # genome-global position: slot pos is chunk-local; add chunk_idx*C
    chunk_off = np.repeat(
        np.arange(n_chunks, dtype=np.int32), cap * cells
    )[None, :] * C
    valid = ~((h.hi == _SENT) & (h.lo == _SENT))
    # keep the documented empty-slot marker: a bare chunk_off add would turn
    # chunk i's sentinel -1 into i*C - 1, a legal-looking position
    pos = jnp.where(
        valid, slot_pos.reshape(B, S) + jnp.asarray(chunk_off), -1
    )
    cell_max = jnp.max(cnt.reshape(B, -1), axis=-1)
    return h, pos, valid, cell_max
