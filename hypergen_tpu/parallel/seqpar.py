"""Single-genome sequence parallelism: one genome's chunk axis over the mesh.

The reference handles arbitrary genome length by chunking 512 k-mers per
CUDA thread with a k-1 halo (reference:src/cuda_kernel.cu:31,39-40) — all on
one device. Here the same chunk decomposition shards across the device mesh
(SURVEY §5 long-context row), so a genome too large for one device's
sketch bucket still sketches, and sketching latency for huge genomes scales with
device count.

Pipeline under shard_map over a 1-D ``seq`` mesh axis:

  chunks [n_chunks, C + k - 1]  sharded P('seq', None)
    -> per-device: hash + FracMinHash threshold + block survivor extraction
       (identical math to the single-device Sketcher step)
    -> all_gather survivors over ``seq``  (tiny: ~C*nc/scaled hashes)
    -> replicated sort + first-occurrence dedup (the HashSet equivalent;
       duplicates can span shards, so dedup must be global)
    -> each device encodes an equal slab of the deduped hash list
       (encode_hv is a sum over hashes, so partial HVs psum exactly)
    -> psum partial int32 HVs over ``seq`` -> replicated HV
    -> i16 wrap + norm2 (reference parity semantics preserved end to end)

Capacity handling mirrors models/sketcher.py: true survivor counts are
returned and the host retries with doubled caps on overflow — never a
silent drop.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hypergen_tpu.io.fastx import INVALID
from hypergen_tpu.models.sketcher import _dedup_sorted_batched
from hypergen_tpu.ops.compact import block_extract, compact_masked
from hypergen_tpu.ops.encode import encode_hv, hv_norm2_i32, hv_to_i16
from hypergen_tpu.ops.kmers import hash_kmer_positions
from hypergen_tpu.ops.u64 import U64
from hypergen_tpu.params import SketchParams

AXIS_SEQ = "seq"


def make_seq_mesh(devices=None) -> Mesh:
    """A 1-D ('seq',) mesh over all (or the given) devices."""
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.asarray(devices), (AXIS_SEQ,))


def _local_sketch(
    chunks: jnp.ndarray,
    *,
    ksize: int,
    seed: int,
    threshold: int,
    hv_d: int,
    extract_block: int,
    chunk_cap: int,
    enc_cap: int,
    n_seq: int,
    canonical: bool,
    method: str,
    encode_block: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-device body (runs under shard_map on the ``seq`` axis)."""
    nc_local, _ = chunks.shape
    C = chunks.shape[1] - (ksize - 1)
    h, keep = hash_kmer_positions(
        chunks, ksize, seed=seed, threshold=threshold,
        canonical=canonical, method=method,
    )
    h = U64(h.hi.reshape(1, nc_local * C), h.lo.reshape(1, nc_local * C))
    keep = keep.reshape(1, nc_local * C)
    if extract_block:
        flat, _, max_count = block_extract(h, keep, extract_block, chunk_cap)
    else:
        # dense-survivor regime (low scaled): scatter-compact the whole
        # shard and sentinel-fill the tail (mirrors models/sketcher.py)
        comp, count = compact_masked(h, keep, chunk_cap)
        slot = jax.lax.broadcasted_iota(jnp.int32, (1, chunk_cap), 1)
        filled = slot < count[:, None]
        sent = np.uint32(0xFFFFFFFF)
        flat = U64(
            jnp.where(filled, comp.hi, sent),
            jnp.where(filled, comp.lo, sent),
        )
        max_count = count
    # gather every shard's (sentinel-padded) survivors; the total is tiny
    # (~positions/scaled), so replication is cheap and keeps dedup exact
    g_hi = jax.lax.all_gather(flat.hi, AXIS_SEQ)  # [n_seq, 1, S]
    g_lo = jax.lax.all_gather(flat.lo, AXIS_SEQ)
    gathered = U64(g_hi.reshape(1, -1), g_lo.reshape(1, -1))
    sorted_h, unique = _dedup_sorted_batched(gathered)
    enc, n_hashes = compact_masked(sorted_h, unique, enc_cap)  # [1, enc_cap]
    # each device encodes its equal slab of the deduped list; encode_hv
    # returns 2*sum(bits) - n_valid per slab, so the psum of slabs equals
    # the full bundle exactly
    slab = enc_cap // n_seq
    di = jax.lax.axis_index(AXIS_SEQ)
    sl = lambda x: jax.lax.dynamic_slice_in_dim(x, di * slab, slab, axis=1)
    enc_slab = U64(sl(enc.hi), sl(enc.lo))
    gpos = jax.lax.broadcasted_iota(jnp.int32, (1, slab), 1) + di * slab
    valid = gpos < n_hashes[:, None]
    hv32 = encode_hv(enc_slab, valid, hv_d, block=encode_block)
    hv32 = jax.lax.psum(hv32, AXIS_SEQ)
    hv16 = hv_to_i16(hv32)
    norm2 = hv_norm2_i32(hv16)
    max_count = jax.lax.pmax(max_count, AXIS_SEQ)
    return hv16[0], norm2[0], n_hashes[0], max_count[0]


@functools.lru_cache(maxsize=None)
def _seqpar_fn(mesh: Mesh, **static) -> object:
    return jax.jit(
        jax.shard_map(
            functools.partial(_local_sketch, **static),
            mesh=mesh,
            in_specs=P(AXIS_SEQ, None),
            out_specs=(P(), P(), P(), P()),
            check_vma=False,  # outputs replicated via psum/all_gather merge
        )
    )


def _chunk_codes(codes: np.ndarray, ksize: int, C: int, n_seq: int) -> np.ndarray:
    """Host: flat base codes -> [n_chunks, C + k - 1] with k-1 halos.

    n_chunks is padded to a multiple of n_seq (whole padding chunks are
    INVALID, contributing nothing).
    """
    n_pos = max(codes.shape[0] - ksize + 1, 1)
    n_chunks = -(-n_pos // C)
    n_chunks = -(-n_chunks // n_seq) * n_seq
    L_ext = n_chunks * C + ksize - 1
    buf = np.full(L_ext, INVALID, dtype=np.uint8)
    n = min(codes.shape[0], L_ext)
    buf[:n] = codes[:n]
    # overlapping rows at stride C over the contiguous buffer: a strided
    # view (then one copy) costs output size only — a fancy-index matrix
    # here would be int64 [n_chunks, C+k-1], 8x the data itself, on the
    # path that exists specifically for huge genomes
    view = np.lib.stride_tricks.as_strided(
        buf, shape=(n_chunks, C + ksize - 1),
        strides=(C * buf.strides[0], buf.strides[0]),
    )
    return np.ascontiguousarray(view)


def sketch_codes_seqpar(
    codes: np.ndarray,
    params: SketchParams,
    mesh: Mesh | None = None,
    chunk_positions: int = 1 << 17,
    extract_block: int = 512,
    encode_block: int = 512,
) -> Dict[str, object]:
    """Sketch ONE genome with its chunk axis sharded over the mesh.

    Returns {"hv": int16 [D], "norm2": int, "n_hashes": int} — bit-identical
    to Sketcher.sketch_codes on a single device (asserted in
    tests/test_parallel.py).
    """
    params.validate()
    if mesh is None:
        mesh = make_seq_mesh()
    n_seq = mesh.devices.size
    C = int(chunk_positions)
    chunks = _chunk_codes(codes, params.ksize, C, n_seq)
    n_chunks = chunks.shape[0]
    if extract_block and params.scaled >= 400 and C % extract_block == 0:
        chunk_cap = 8  # slots per extract_block positions
    else:
        # dense survivors: compact the whole shard, cap on total count
        extract_block = 0
        local_pos = n_chunks * C // n_seq
        chunk_cap = int(
            -(-max(256, local_pos * 13 // (10 * max(params.scaled, 1)))
              // 256) * 256
        )
    expected = n_chunks * C // max(params.scaled, 1)
    enc_cap = -(-(3 * expected + 512) // (256 * n_seq)) * 256 * n_seq
    sharding = NamedSharding(mesh, P(AXIS_SEQ, None))
    for _ in range(8):
        fn = _seqpar_fn(
            mesh,
            ksize=params.ksize,
            seed=params.seed,
            threshold=params.threshold,
            hv_d=params.hv_d,
            extract_block=extract_block,
            chunk_cap=chunk_cap,
            enc_cap=enc_cap,
            n_seq=n_seq,
            canonical=params.canonical,
            method=params.sketch_method,
            encode_block=encode_block,
        )
        hv, norm2, n_hashes, max_count = jax.device_get(
            fn(jax.device_put(chunks, sharding))
        )
        if int(max_count) <= chunk_cap and int(n_hashes) <= enc_cap:
            return {
                "hv": np.asarray(hv),
                "norm2": int(norm2),
                "n_hashes": int(n_hashes),
            }
        if int(max_count) > chunk_cap:
            chunk_cap *= 2
        if int(n_hashes) > enc_cap:
            enc_cap *= 2
    raise RuntimeError("seqpar capacity retry limit exceeded")
