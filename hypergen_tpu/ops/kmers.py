"""Chunked canonical k-mer extraction and hashing (shape-static, fusion-friendly).

Replaces the reference's two inner loops — needletail's canonical_kmers
iterator (CPU path, reference:src/sketch.rs:89-95) and the CUDA per-thread
ASCII-buffer loop (reference:src/cuda_kernel.cu:250-321) — with a fully
vectorized formulation:

  - the host supplies 2-bit base codes (0..3, 4 = invalid) for a chunk of
    sequence with a k-1 halo, as produced by io.fastx;
  - for each of the P = len-k+1 window positions we build, via a k-step
    unrolled loop of shifted slices (no gathers):
      * a validity flag (all k bases ACGT),
      * 2-bit packed forward/revcomp keys (first base most significant,
        same packing as reference:src/cuda_kernel.cu:49-51),
      * the canonical strand by numeric key comparison — equivalent to the
        reference's bytewise strcmp because ASCII order of A<C<G<T matches
        2-bit code order,
      * the canonical k-mer's ASCII bytes packed into little-endian u64
        words, i.e. exactly the t1ha2_atonce input layout;
  - hashes every window with t1ha2 (or mm_hash64 of the packed key for the
    "mmhash" method) and applies the FracMinHash threshold.

Everything is elementwise over [..., P]; XLA fuses the whole chain.
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp
import numpy as np

from hypergen_tpu.ops import u64 as u
from hypergen_tpu.ops.hashes import mm_hash64, t1ha2_atonce_words
from hypergen_tpu.ops.u64 import U64

INVALID_CODE = 4  # host encodes non-ACGT bases as 4


def _ascii_from_code(c: jnp.ndarray) -> jnp.ndarray:
    """2-bit code -> ASCII base as uint32 (A=65 C=67 G=71 T=84)."""
    c = c.astype(jnp.uint32)
    return (
        np.uint32(65)
        + (c << 1)
        + ((c >> 1) << 1)
        + jnp.where(c == 3, np.uint32(11), np.uint32(0))
    )


def canonical_kmer_words(
    codes: jnp.ndarray, ksize: int, canonical: bool = True
) -> Tuple[List[U64], U64, jnp.ndarray]:
    """Build per-position t1ha2 input words + packed key + validity.

    codes: int32/uint8 array [..., L] of base codes (0..3 valid, >=4 invalid),
    L >= ksize. Returns (words, key, valid) where
      - words: list of ceil(k/8) U64s of shape [..., P], P = L - k + 1 —
        little-endian ASCII bytes of the canonical k-mer, tail zero-padded;
      - key: U64 [..., P] — canonical 2-bit packed k-mer (mmhash input);
      - valid: bool [..., P].
    """
    if not 1 <= ksize <= 32:
        raise ValueError("ksize must be in [1, 32]")
    codes = codes.astype(jnp.uint32)
    L = codes.shape[-1]
    P = L - ksize + 1
    if P < 1:
        raise ValueError(f"chunk too short: L={L} < k={ksize}")

    def win(j: int) -> jnp.ndarray:
        return jnp.asarray(codes[..., j : j + P])

    zero = jnp.zeros(codes.shape[:-1] + (P,), dtype=jnp.uint32)

    valid = None
    fwd_hi = zero
    fwd_lo = zero
    rc_hi = zero
    rc_lo = zero
    fwd_bases = []
    for j in range(ksize):
        base = win(j)
        fwd_bases.append(base)
        ok = base < INVALID_CODE
        valid = ok if valid is None else (valid & ok)
        # fwd key: base j shifts in at the LSB end
        fk = u.shl(U64(fwd_hi, fwd_lo), 2)
        fwd_hi, fwd_lo = fk.hi, fk.lo | (base & np.uint32(3))
        # rc key: complement of base (k-1-j); build in the same order
        rbase = (np.uint32(3) - (win(ksize - 1 - j) & np.uint32(3))) & np.uint32(3)
        rk = u.shl(U64(rc_hi, rc_lo), 2)
        rc_hi, rc_lo = rk.hi, rk.lo | rbase

    fwd_key = U64(fwd_hi, fwd_lo)
    rc_key = U64(rc_hi, rc_lo)
    if canonical:
        is_rc = u.lt(rc_key, fwd_key)
        key = u.select(is_rc, rc_key, fwd_key)
    else:
        is_rc = jnp.zeros_like(valid)
        key = fwd_key

    # canonical ASCII bytes packed into u32 words, 4 bytes per u32, LE
    n_u32 = (ksize + 3) // 4
    words_u32 = [zero for _ in range(n_u32)]
    for j in range(ksize):
        cbase = fwd_bases[j] & np.uint32(3)
        if canonical:
            rbase = (np.uint32(3) - (fwd_bases[ksize - 1 - j] & np.uint32(3))) & np.uint32(3)
            cbase = jnp.where(is_rc, rbase, cbase)
        ascii_b = _ascii_from_code(cbase)
        q, sh = divmod(j, 4)
        words_u32[q] = words_u32[q] | (ascii_b << np.uint32(8 * sh))

    n_words = (ksize + 7) // 8
    words: List[U64] = []
    for w in range(n_words):
        lo = words_u32[2 * w]
        hi = words_u32[2 * w + 1] if 2 * w + 1 < n_u32 else zero
        words.append(U64(hi, lo))
    return words, key, valid


def hash_kmer_positions(
    codes: jnp.ndarray,
    ksize: int,
    seed: int,
    threshold: int,
    canonical: bool = True,
    method: str = "t1ha2",
) -> Tuple[U64, jnp.ndarray]:
    """Hash every k-mer window and apply the FracMinHash filter.

    Returns (hash: U64 [..., P], keep: bool [..., P]) with
    keep = window-valid AND hash < threshold
    (reference:src/sketch.rs:90-94).
    """
    words, key, valid = canonical_kmer_words(codes, ksize, canonical)
    if method == "t1ha2":
        h = t1ha2_atonce_words(words, ksize, seed)
    elif method == "mmhash":
        h = mm_hash64(key)
    else:
        raise ValueError(f"unknown sketch method {method!r}")
    keep = valid & u.lt_const(h, threshold)
    # zero out non-kept hashes so downstream compaction sees clean data
    zero = jnp.zeros_like(h.lo)
    h = U64(jnp.where(keep, h.hi, zero), jnp.where(keep, h.lo, zero))
    return h, keep
