"""JAX/XLA/Pallas device ops: the fast path of the framework.

Every 64-bit quantity (t1ha2 state, wyrng state, FracMinHash
hashes/threshold) is a pair of uint32 arrays (``ops.u64.U64``), so the
package runs with JAX's default 32-bit types; multiplies decompose to
16-bit limbs on 32-bit lanes. Everything is
shape-static and jit/fusion friendly; hot loops additionally have Pallas
kernel variants under ``ops.pallas`` with XLA fallbacks.
"""

from hypergen_tpu.ops.u64 import U64  # noqa: F401
