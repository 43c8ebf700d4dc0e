"""HDC random-indexing HV encoder (the second hot loop, reference:src/hd.rs:94-112).

The reference seeds a WyRng per sampled hash and draws D/64 sequential u64
words. Because wyrng's state is a plain counter (state_i = h + (i+1)*P0),
the whole [N_hashes x D/64] word grid is computable in parallel with zero
sequential dependencies — the key observation that makes this op a single
fused elementwise pipeline + reduction instead of a loop.

hv[i*64 + j] = sum over hashes h of (2*bit_j(word_i(h)) - 1)
            = 2 * popcount-accumulate - n_hashes.

Padding hashes are masked to contribute nothing, matching the reference's
AVX2 padding semantics (reference:src/hd.rs:54-58 zero the padded lanes).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from hypergen_tpu.ops import u64 as u
from hypergen_tpu.ops.hashes import wyrng_word_offsets, wyrng_words_from_hash
from hypergen_tpu.ops.u64 import U64

_BIT_SHIFTS = np.arange(32, dtype=np.uint32)


def _expand_bits(w_hi: jnp.ndarray, w_lo: jnp.ndarray) -> jnp.ndarray:
    """[..., W] u32 word pairs -> [..., W*64] int8 bits in dim order.

    dim d = i*64 + j: j in [0,32) from lo bit j, j in [32,64) from hi
    bit j-32 (reference:src/hd.rs:102-107: hv[i*64+j] += (rnd>>j)&1 over a
    64-bit word, LSB first).
    """
    lo_bits = (w_lo[..., None] >> _BIT_SHIFTS) & np.uint32(1)
    hi_bits = (w_hi[..., None] >> _BIT_SHIFTS) & np.uint32(1)
    bits = jnp.concatenate([lo_bits, hi_bits], axis=-1)  # [..., W, 64]
    return bits.astype(jnp.int8).reshape(bits.shape[:-2] + (-1,))


def _csa_block_counts(
    w_hi: jnp.ndarray, w_lo: jnp.ndarray, valid: jnp.ndarray
) -> jnp.ndarray:
    """Per-dimension bit counts of a block via a carry-save adder tree.

    w_hi/w_lo: uint32 [B, n, W] wyrng word halves (n a power of two);
    valid: bool [B, n]. Returns int32 [B, W*64] column sums in the same
    dim order as _expand_bits (word i -> dims i*64+j, lo bits j<32 first).

    Instead of expanding every word to hv_d int8 bit lanes and widening to
    int32 (~5 vector ops per hash*dim), the block axis is reduced with bitwise
    full adders on the packed u32 words: level t of the tree merges pairs of
    t-bit bit-sliced counters at ~5 ops per plane, so the whole reduction
    costs ~sum(5t/2^t) ~ 10 ops per hash per u32 plane (~0.3 ops per
    hash*dim). The per-bit expansion then runs once per block over the
    log2(n)+1 counter planes rather than over all n words. Exact integer
    arithmetic, bit-identical to the expand-and-sum formulation.
    """
    B, n, W = w_lo.shape
    if n & (n - 1):
        raise ValueError("CSA block length must be a power of two")
    words = jnp.concatenate([w_lo, w_hi], axis=-1)  # [B, n, 2W]
    words = jnp.where(valid[..., None], words, jnp.uint32(0))
    planes = [words]  # planes[t] holds bit t of the running column counts
    while planes[0].shape[1] > 1:
        a = [p[:, 0::2] for p in planes]
        b = [p[:, 1::2] for p in planes]
        out = []
        carry = None
        for pa, pb in zip(a, b):
            if carry is None:  # half adder at the lowest level
                out.append(pa ^ pb)
                carry = pa & pb
            else:  # full adder: sum = a^b^c, carry = maj(a, b, c)
                t = pa ^ pb
                out.append(t ^ carry)
                carry = (pa & pb) | (carry & t)
        out.append(carry)
        planes = out
    counts = None
    for t, p in enumerate(planes):
        bits = ((p[:, 0, :, None] >> _BIT_SHIFTS) & np.uint32(1)).astype(
            jnp.int32
        )
        contrib = bits << t
        counts = contrib if counts is None else counts + contrib
    c_lo, c_hi = counts[:, :W], counts[:, W:]  # [B, W, 32] each
    return jnp.concatenate([c_lo, c_hi], axis=-1).reshape(B, W * 64)


@functools.partial(jax.jit, static_argnames=("hv_d", "block", "csa"))
def encode_hv(
    h: U64,
    valid: jnp.ndarray,
    hv_d: int,
    block: int = 256,
    csa: bool | None = None,
) -> jnp.ndarray:
    """Bundle hashes into an int32 HV (wrap to int16 at the end for parity).

    h: U64 [B, N] (padded hash buffers); valid: bool [B, N].
    Returns int32 [B, hv_d] = 2*sum(bits) - n_valid per row.
    Processes hashes in blocks to bound the [B, block, hv_d] bit tensor.
    csa: None = auto (CSA column counters whenever block is a power of
    two); True/False force the path (CSA requires pow2 block). Both paths
    are bit-identical; the flag exists for A/B measurement.
    """
    if hv_d % 64 != 0:
        raise ValueError("hv_d must be a multiple of 64")
    B, N = h.lo.shape
    W = hv_d // 64
    offsets = u.from_np_u64(wyrng_word_offsets(W))

    if N % block != 0:
        pad = block - N % block
        h = U64(
            jnp.pad(h.hi, ((0, 0), (0, pad))),
            jnp.pad(h.lo, ((0, 0), (0, pad))),
        )
        valid = jnp.pad(valid, ((0, 0), (0, pad)))
        N += pad
    n_blocks = N // block

    if csa is None:
        csa = (block & (block - 1)) == 0
    elif csa and block & (block - 1):
        raise ValueError("csa=True requires a power-of-two block")

    def body(i, acc):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, i * block, block, axis=1)
        hb = U64(sl(h.hi), sl(h.lo))
        vb = sl(valid)
        w_hi, w_lo = wyrng_words_from_hash(hb, offsets)  # [B, block, W]
        if csa:
            return acc + _csa_block_counts(w_hi, w_lo, vb)
        bits = _expand_bits(w_hi, w_lo)  # [B, block, hv_d] int8
        masked = bits * vb[..., None].astype(jnp.int8)
        return acc + jnp.sum(masked.astype(jnp.int32), axis=1)

    acc = jnp.zeros((B, hv_d), dtype=jnp.int32)
    acc = jax.lax.fori_loop(0, n_blocks, body, acc)
    n_valid = jnp.sum(valid.astype(jnp.int32), axis=-1, keepdims=True)
    return 2 * acc - n_valid


def hv_to_i16(hv: jnp.ndarray) -> jnp.ndarray:
    """Wrap to int16 exactly like the reference's i16 accumulation
    (overflow-checks=false; reference:src/hd.rs:97)."""
    return hv.astype(jnp.int16)


def hv_norm2_i32(hv_i16: jnp.ndarray) -> jnp.ndarray:
    """Wrapping-i32 sum of squares (reference:src/dist.rs:132-137)."""
    x = hv_i16.astype(jnp.int32)
    return jnp.sum(x * x, axis=-1)
