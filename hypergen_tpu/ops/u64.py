"""Vectorized u64 arithmetic as (hi, lo) uint32 pairs.

JAX runs with 32-bit types by default; the reference's hash stack
(t1ha2 / wyrng / mm_hash64 / FracMinHash threshold) is pure 64-bit integer
math. This module provides exact wrapping u64 semantics on top of uint32
lanes, with multiplies decomposed to 16-bit limbs (the same decomposition
strategy the reference uses for its device t1ha2 port,
reference:src/cuda_kernel.cu:110-134, chosen there for 32-bit compatibility).

All functions are elementwise over arbitrary array shapes, trace cleanly
under jit/vmap/shard_map, and are usable inside Pallas kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
_MASK16 = np.uint32(0xFFFF)


class U64(NamedTuple):
    """A u64 tensor as two uint32 tensors (hi, lo). Registered pytree."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @property
    def shape(self):
        return jnp.shape(self.lo)

    def __getitem__(self, idx):  # type: ignore[override]
        return U64(self.hi[idx], self.lo[idx])

    def reshape(self, *shape):
        return U64(self.hi.reshape(*shape), self.lo.reshape(*shape))

    def astype_u32(self) -> Tuple[jnp.ndarray, jnp.ndarray]:
        return self.hi, self.lo


def from_scalar(value: int, shape=(), dtype=_U32) -> U64:
    """Broadcast a Python-int u64 constant."""
    value &= (1 << 64) - 1
    hi = jnp.full(shape, np.uint32(value >> 32), dtype=dtype)
    lo = jnp.full(shape, np.uint32(value & 0xFFFFFFFF), dtype=dtype)
    return U64(hi, lo)


def from_np_u64(arr: np.ndarray) -> U64:
    """Host numpy uint64 array -> device U64."""
    arr = np.asarray(arr, dtype=np.uint64)
    return U64(
        jnp.asarray((arr >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
    )


def to_np_u64(x: U64) -> np.ndarray:
    """Device U64 -> host numpy uint64 array."""
    hi = np.asarray(x.hi, dtype=np.uint64)
    lo = np.asarray(x.lo, dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=_U32)


# --- add / sub --------------------------------------------------------------


def add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(_U32)
    return U64(a.hi + b.hi + carry, lo)


def add_carry(a: U64, b: U64) -> Tuple[U64, jnp.ndarray]:
    """64-bit add returning (sum, carry_out) — add64carry_first semantics
    (reference:src/cuda_kernel.cu:96-101)."""
    lo = a.lo + b.lo
    c0 = (lo < a.lo).astype(_U32)
    hi = a.hi + b.hi
    c1 = (hi < a.hi).astype(_U32)
    hi2 = hi + c0
    c2 = (hi2 < hi).astype(_U32)
    return U64(hi2, lo), c1 | c2


def add3(a: U64, b: U64, carry: jnp.ndarray) -> U64:
    """a + b + carry (carry is 0/1 u32) — add64carry_last semantics."""
    lo = a.lo + b.lo
    c0 = (lo < a.lo).astype(_U32)
    lo2 = lo + carry
    c1 = (lo2 < lo).astype(_U32)
    return U64(a.hi + b.hi + c0 + c1, lo2)


def add_const(a: U64, value: int) -> U64:
    value &= (1 << 64) - 1
    vhi = np.uint32(value >> 32)
    vlo = np.uint32(value & 0xFFFFFFFF)
    lo = a.lo + vlo
    carry = (lo < a.lo).astype(_U32)
    return U64(a.hi + vhi + carry, lo)


# --- bitwise ----------------------------------------------------------------


def xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def xor_const(a: U64, value: int) -> U64:
    value &= (1 << 64) - 1
    return U64(a.hi ^ np.uint32(value >> 32), a.lo ^ np.uint32(value & 0xFFFFFFFF))


def and_const(a: U64, value: int) -> U64:
    value &= (1 << 64) - 1
    return U64(a.hi & np.uint32(value >> 32), a.lo & np.uint32(value & 0xFFFFFFFF))


def not_(a: U64) -> U64:
    return U64(~a.hi, ~a.lo)


def or_(a: U64, b: U64) -> U64:
    return U64(a.hi | b.hi, a.lo | b.lo)


# --- shifts / rotates (static shift amounts only) ---------------------------


def shl(a: U64, s: int) -> U64:
    assert 0 <= s < 64
    if s == 0:
        return a
    if s < 32:
        return U64((a.hi << s) | (a.lo >> (32 - s)), a.lo << s)
    if s == 32:
        return U64(a.lo, jnp.zeros_like(a.lo))
    return U64(a.lo << (s - 32), jnp.zeros_like(a.lo))


def shr(a: U64, s: int) -> U64:
    assert 0 <= s < 64
    if s == 0:
        return a
    if s < 32:
        return U64(a.hi >> s, (a.lo >> s) | (a.hi << (32 - s)))
    if s == 32:
        return U64(jnp.zeros_like(a.hi), a.hi)
    return U64(jnp.zeros_like(a.hi), a.hi >> (s - 32))


def rot_right(a: U64, s: int) -> U64:
    """rot64(v, s) = (v >> s) | (v << (64 - s)) (reference:src/cuda_kernel.cu:91-93)."""
    assert 0 < s < 64
    return or_(shr(a, s), shl(a, 64 - s))


# --- comparisons ------------------------------------------------------------


def lt(a: U64, b: U64) -> jnp.ndarray:
    """Unsigned a < b."""
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def lt_const(a: U64, value: int) -> jnp.ndarray:
    value &= (1 << 64) - 1
    vhi = np.uint32(value >> 32)
    vlo = np.uint32(value & 0xFFFFFFFF)
    return (a.hi < vhi) | ((a.hi == vhi) & (a.lo < vlo))


def eq(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi == b.hi) & (a.lo == b.lo)


def select(pred: jnp.ndarray, a: U64, b: U64) -> U64:
    return U64(jnp.where(pred, a.hi, b.hi), jnp.where(pred, a.lo, b.lo))


# --- multiplies -------------------------------------------------------------


def mul32x32_64(a: jnp.ndarray, b: jnp.ndarray) -> U64:
    """Full 32x32 -> 64 product via 16-bit limbs (u32 lanes only)."""
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    p00 = a0 * b0
    p11 = a1 * b1
    mid = a0 * b1
    mid2 = mid + a1 * b0
    carry_mid = (mid2 < mid).astype(_U32)
    lo = p00 + (mid2 << 16)
    carry_lo = (lo < p00).astype(_U32)
    hi = p11 + (mid2 >> 16) + (carry_mid << 16) + carry_lo
    return U64(hi, lo)


def mul_lo(a: U64, b: U64) -> U64:
    """Low 64 bits of a*b (enough for t1ha2's final64 prime multiplies)."""
    ll = mul32x32_64(a.lo, b.lo)
    cross = a.lo * b.hi + a.hi * b.lo  # u32 wrap is correct for bits 32..63
    return U64(ll.hi + cross, ll.lo)


def mul_lo_const(a: U64, value: int) -> U64:
    return mul_lo(a, from_scalar(value))


def mul128(a: U64, b: U64) -> Tuple[U64, U64]:
    """64x64 -> 128 product as (hi64, lo64).

    Mirrors mul_64x64_128 (reference:src/cuda_kernel.cu:116-133): four
    32x32->64 partials combined with explicit carries.
    """
    ll = mul32x32_64(a.lo, b.lo)
    lh = mul32x32_64(a.hi, b.lo)
    hl = mul32x32_64(a.lo, b.hi)
    hh = mul32x32_64(a.hi, b.hi)

    zero = jnp.zeros_like(a.lo)
    # l = ll + (lh << 32); h = hh + (lh >> 32) + carry
    l1, c1 = add_carry(ll, U64(lh.lo, zero))
    h1 = add3(hh, U64(zero, lh.hi), c1)
    # l = l + (hl << 32); h = h + (hl >> 32) + carry
    l2, c2 = add_carry(l1, U64(hl.lo, zero))
    h2 = add3(h1, U64(zero, hl.hi), c2)
    return h2, l2


def mul128_const(a: U64, value: int) -> Tuple[U64, U64]:
    """a * const -> (hi, lo); saves the hh/hl work when const fits patterns.

    Kept general (full mul128 with broadcast constant) for clarity; XLA
    constant-folds the limb splits.
    """
    return mul128(a, from_scalar(value))


def mux64(v: U64, prime: int) -> U64:
    """lo ^ hi of v*prime (reference:src/cuda_kernel.cu:143-147)."""
    hi, lo = mul128_const(v, prime)
    return xor(hi, lo)
