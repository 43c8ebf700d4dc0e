"""HyperGen in JAX: genome sketching in hyperdimensional space on accelerators.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of wh-xu/Hyper-Gen
(Bioinformatics 2024): FracMinHash k-mer sampling, hyperdimensional (HDC)
sketch encoding, and ANI estimation via dense hypervector dot products.

Architecture:
  - ``ops``      u64-as-2xu32 integer emulation, vectorized t1ha2 / wyrng /
                 mm_hash64, chunked canonical k-mer extraction, HV encoding,
                 exact ANI matmuls (int8 tensor-core split), Pallas kernels.
  - ``backend``  the one table of per-backend path choices.
  - ``io``       FASTA reading + needletail-compatible normalization,
                 BitPacker8x-compatible HV compression, bincode-compatible
                 ``.sketch`` serialization, sharded sketch DB + manifest.
  - ``models``   end-to-end jitted sketch / comparator models.
  - ``parallel`` device meshes, sharded DB search with collective top-k merge.
  - ``oracle``   pure-Python parity oracle (test anchor, not a fast path).
  - ``utils``    logging, progress, timing.

Reference behavior contracts are cited inline as ``reference:<file>:<lines>``
pointing into the upstream Rust/CUDA repo snapshot.
"""

__version__ = "0.1.0"

from hypergen_tpu.params import SketchParams, DistParams  # noqa: F401
