"""The flagship model: genome base codes -> sketch hypervector, fully on device.

Pipeline (one jit-compiled step per (batch, chunk-count) bucket):

  packed 2-bit bases + validity bitmask  [B, ...]   (3.2x smaller H2D)
    -> on-device unpack to base codes
    -> fused canonical k-mer hash + FracMinHash     (Pallas rolling kernel on
       the GPU, the ops.kmers XLA step elsewhere; backend.caps() decides)
    -> scatter-free masked-max survivor extraction  (ops.compact.block_extract)
    -> per-genome sort + unique (HashSet-equivalent dedup on device;
       sentinel U64_MAX marks empty slots — it can never be a survivor
       because the keep test is strict `h < threshold`)
    -> wyrng-expand + bundle HV encode              (ops.encode)
    -> i16 wrap + L2 norm^2

This replaces the reference's per-file rayon loop + HashSet
(reference:src/sketch.rs:35-56) and its GPU slot-array kernel
(reference:src/sketch_cuda.rs:120-166) with a static-shape, fusion-friendly
XLA program. Capacity overflows are *detected* (true counts returned) and
retried with doubled capacity — never silently dropped (unlike
reference:src/cuda_kernel.cu:316).

Batching many genomes per dispatch amortizes launch overhead; host-side
packing and FASTA parsing run in a thread pool overlapped with device work.
Genomes are bucketed by chunk count (powers of two) so the number of
distinct compiled programs stays logarithmic in genome length.
"""

from __future__ import annotations

import collections
import functools
import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from hypergen_tpu.io.fastx import (
    INVALID,
    PackedGenome,
    invalid_runs,
    pack2bit,
    read_genome_packed,
)
from hypergen_tpu.backend import caps
from hypergen_tpu.io.sketch_db import FileSketch
from hypergen_tpu.ops.compact import block_extract, compact_masked
from hypergen_tpu.ops.encode import encode_hv, hv_norm2_i32, hv_to_i16
from hypergen_tpu.ops.kmers import hash_kmer_positions
from hypergen_tpu.ops.pallas.hash_kernel import hash_packed_rows, packed_cells
from hypergen_tpu.ops.u64 import U64
from hypergen_tpu.params import SketchParams

log = logging.getLogger("hypergen")

_SENT = np.uint32(0xFFFFFFFF)


def _pad_and_pack2bit(codes: np.ndarray, padded_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """(INVALID-padded buffer, 2-bit packed bytes) for a code array.

    The pack itself is io.fastx.pack2bit (one algorithm, one home);
    INVALID codes fold to 0 under the &3 mask, matching the kernel's
    packed-garbage-repaired-by-runs contract.
    """
    n = min(codes.shape[0], padded_len)
    buf = np.full(padded_len, INVALID, dtype=np.uint8)
    buf[:n] = codes[:n]
    return buf, pack2bit(buf)


def pack_codes(codes: np.ndarray, padded_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side 2-bit base + validity bitmask packing (3.2x H2D reduction).

    codes: uint8 [L] with 0..3 = base, >=4 = invalid. Returns
    (packed2 [padded_len/4] u8, packedv [padded_len/8] u8); padding is
    invalid. padded_len must be a multiple of 8.
    """
    buf, packed2 = _pad_and_pack2bit(codes, padded_len)
    packedv = np.packbits(buf < INVALID, bitorder="little")
    return packed2, packedv


def _unpack_codes(packed2: jnp.ndarray, packedv: jnp.ndarray) -> jnp.ndarray:
    """Device-side unpack: [..., L/4] + [..., L/8] u8 -> [..., L] codes."""
    shifts2 = np.arange(4, dtype=np.uint8) * 2
    b = (packed2[..., None] >> shifts2) & np.uint8(3)
    b = b.reshape(b.shape[:-2] + (-1,))
    shiftsv = np.arange(8, dtype=np.uint8)
    v = (packedv[..., None] >> shiftsv) & np.uint8(1)
    v = v.reshape(v.shape[:-2] + (-1,))
    return jnp.where(v > 0, b, np.uint8(INVALID))


def find_invalid_runs(codes: np.ndarray, genome_len: int, padded_len: int) -> np.ndarray:
    """Host: [R, 2] int32 (start, end) runs of invalid positions.

    Invalid bases (N runs, record separators) are rare and clustered, so a
    run list is hundreds of bytes where a dense validity bitmask is
    padded_len/8. The run-finding core is io.fastx.invalid_runs; this adds the
    tail padding run [genome_len, padded_len).
    """
    runs = invalid_runs(codes[: min(genome_len, padded_len)])
    if genome_len < padded_len:
        if runs.size and runs[-1, 1] == genome_len:
            runs[-1, 1] = padded_len  # merge with tail padding
        else:
            runs = np.concatenate(
                [runs, np.array([[genome_len, padded_len]], np.int32)]
            )
    return runs


_NATIVE_PACK = None
_NATIVE_PACK_TRIED = False


def _native_pack():
    global _NATIVE_PACK, _NATIVE_PACK_TRIED
    if not _NATIVE_PACK_TRIED:
        _NATIVE_PACK_TRIED = True
        try:
            from hypergen_tpu.io.fastx_native import pack_codes_runs as f

            # probe once; any failure -> permanent numpy fallback
            f(np.zeros(8, np.uint8), 8, 4)
            _NATIVE_PACK = f
        except Exception:
            _NATIVE_PACK = None
    return _NATIVE_PACK


def pack_codes_runs(
    codes: np.ndarray, padded_len: int, run_cap: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Host packing for the runs-validity step variant.

    Returns (packed2 [padded_len/4] u8, runs [run_cap, 2] i32 zero-padded,
    n_runs). n_runs > run_cap means the run list did not fit: caller must
    fall back to the dense-mask variant (correctness is never traded).
    Uses the C++ packer (native/fastx.cpp hg_pack_codes) when available.
    """
    native = _native_pack()
    if native is not None:
        return native(codes, padded_len, run_cap)
    n = min(codes.shape[0], padded_len)
    _, packed2 = _pad_and_pack2bit(codes, padded_len)
    runs = find_invalid_runs(codes, n, padded_len)
    n_runs = runs.shape[0]
    out = np.zeros((run_cap, 2), dtype=np.int32)
    out[: min(n_runs, run_cap)] = runs[:run_cap]
    return packed2, out, n_runs


def _valid_from_runs(runs: jnp.ndarray, length: int) -> jnp.ndarray:
    """Device: [B, R, 2] int32 invalid runs -> [B, length] bool valid mask.

    +1/-1 deltas scattered at run starts/ends, prefix-summed: a position is
    valid iff it is covered by zero runs. Zero-padded runs (start==end==0)
    are no-ops.
    """
    B, R, _ = runs.shape
    # int16 delta: runs are disjoint so the prefix sum stays in {0, 1}, and
    # even all R zero-padded rows cancelling at index 0 fit comfortably —
    # halves the HBM traffic of this length-sized intermediate vs int32
    delta = jnp.zeros((B, length + 1), dtype=jnp.int16)
    bidx = jax.lax.broadcasted_iota(jnp.int32, (B, R), 0)
    starts = jnp.clip(runs[:, :, 0], 0, length)
    ends = jnp.clip(runs[:, :, 1], 0, length)
    delta = delta.at[bidx, starts].add(1, mode="drop")
    delta = delta.at[bidx, ends].add(-1, mode="drop")
    return jnp.cumsum(delta[:, :length], axis=-1) == 0


def _dedup_sorted_batched(h: U64) -> Tuple[U64, jnp.ndarray]:
    """Row-wise sort of [B, N] U64 and first-occurrence mask (no sentinel)."""
    hi_s, lo_s = jax.lax.sort((h.hi, h.lo), dimension=-1, num_keys=2)
    prev_hi = jnp.concatenate(
        [jnp.full(hi_s.shape[:-1] + (1,), _SENT), hi_s[..., :-1]], axis=-1
    )
    prev_lo = jnp.concatenate(
        [jnp.full(lo_s.shape[:-1] + (1,), _SENT), lo_s[..., :-1]], axis=-1
    )
    is_sent = (hi_s == _SENT) & (lo_s == _SENT)
    differs = (hi_s != prev_hi) | (lo_s != prev_lo)
    return U64(hi_s, lo_s), differs & ~is_sent


def packed_row_words(n_chunks: int, chunk_positions: int) -> int:
    """u32 words per genome row for the fused packed step (16 codes/word;
    slack words cover the last cell's k-1 halo read, at most 2 words for
    k <= 32)."""
    return n_chunks * chunk_positions // 16 + 4


def packed_be_cap_default(chunk_positions: int, scaled: int) -> int:
    """Initial plane-0 block_extract slot cap for the packed path.

    Slot plane 0 (first survivor of each cell) is the dense one: a
    128-slot block there covers 128 cells, rate <= 128*lsub/scaled. Sized
    with a lambda + 6*sqrt(lambda) tail margin (retry ladder backstops)."""
    cells = packed_cells(chunk_positions)
    if not cells:
        return 8
    lam = 128 * (chunk_positions // cells) / max(scaled, 1)
    return int(min(128, max(8, lam + 6 * lam ** 0.5 + 4)))


def filter_positions_by_runs(
    pos: jnp.ndarray, runs: jnp.ndarray, ksize: int
) -> jnp.ndarray:
    """Device postfilter: which k-mer windows avoid every invalid run.

    pos: i32 [B, S] genome-global k-mer starts (window [p, p+k)).
    runs: i32 [B, R, 2] disjoint [start, end) invalid runs, padded with
    INT32_MAX rows. Returns bool [B, S]: True = window clean.

    Dense broadcast-compare + any-reduce over the run axis: S*R bool ops,
    zero gathers (a searchsorted would need log R dependent gathers per
    query) — at S ~ 3e4 extracted survivors and R = 512 the dense form is
    one fused reduction.
    """
    starts = runs[:, None, :, 0]  # [B, 1, R]
    ends = runs[:, None, :, 1]
    p = pos[:, :, None]
    hit = (starts < p + ksize) & (ends > p)
    return ~jnp.any(hit, axis=-1)


def make_sketch_step(
    ksize: int,
    seed: int,
    threshold: int,
    hv_d: int,
    batch: int,
    n_chunks: int,
    chunk_positions: int,
    chunk_cap: int,
    enc_cap: int,
    canonical: bool = True,
    method: str = "t1ha2",
    encode_block: int = 256,
    extract_block: int = 512,
    jit_compile: bool = True,
    validity: str = "mask",
    interpret: bool = False,
    packed_be_cap: int = 8,
    probe: Optional[str] = None,
):
    """Batched sketch step: B packed genomes -> B sketch HVs in one dispatch.

    Genome layout: each genome occupies L_ext = n_chunks*C + k - 1 padded
    positions (invalid padding). chunk_cap = survivor slots per
    extract_block positions (block path), per chunk (scatter path when
    extract_block == 0), or per kernel cell ("packed").

    validity: "mask" takes (packed2 [B, L/4] u8, packedv [B, L/8] u8);
    "runs" takes (packed2, runs [B, R, 2] i32 invalid-run list) — 8x less
    H2D for the validity side; "packed" (the GPU default) takes
    (packed words u32 [B, W], runs, n_pos i32 [B]) and runs the fused
    Pallas kernel: unpack, hash, threshold, and per-cell survivor
    compaction in registers, with invalid windows repaired by the sparse
    run postfilter — device memory never sees a position-dense
    intermediate. interpret runs that kernel in Pallas interpret mode
    (off the GPU).

    probe (packed path only, profiling support): stop the step early and
    return a scalar-reducible stand-in — "hash" (after the kernel),
    "extract" (after extraction + postfilter), "dedup" (after the sort).
    probe="hashes" (any validity mode) is a PRODUCTION variant: skip the
    encode and return the deduped survivor hashes themselves, fused with
    the capacity meta into one int32 output [B, 2*E + 5] (hi | lo |
    [occ, n_hashes, max_count, extra_count, 0]; non-unique/empty slots
    carry the U64_MAX sentinel). The single-device tiled huge-genome path
    unions these per-tile sets on host — dedup composes as set union and
    the HV encode as a sum, so tiling is exact.
    """
    C = chunk_positions
    k = ksize
    L_ext = n_chunks * C + k - 1
    L_pad = -(-L_ext // 8) * 8

    def _finish(flat: U64, max_count, extra_count):
        """Shared back half: dedup, encode, fused output assembly."""

        def _norm_max_count(mc):
            if mc.ndim == 0:
                return jnp.broadcast_to(mc, (batch,))
            if mc.ndim > 1:  # per-block counts: reduce to per-genome
                return jnp.max(mc, axis=-1)
            return mc

        def _hashes_out(hi, lo, mask, n_hashes, occ):
            # fused int32 [B, 2E + 5]: masked sorted hashes + the SAME meta
            # column order as the HV output so the host capacity ladder is
            # shared (col 0 = norm2 slot, unused here)
            hi_m = jax.lax.bitcast_convert_type(
                jnp.where(mask, hi, _SENT), jnp.int32
            )
            lo_m = jax.lax.bitcast_convert_type(
                jnp.where(mask, lo, _SENT), jnp.int32
            )
            meta = jnp.stack(
                [jnp.zeros((batch,), jnp.int32), n_hashes,
                 _norm_max_count(max_count), extra_count, occ], axis=-1,
            )
            return jnp.concatenate([hi_m, lo_m, meta], axis=-1)

        sorted_h, unique = _dedup_sorted_batched(flat)
        if probe == "dedup":
            return (
                jnp.sum(sorted_h.lo.astype(jnp.int32))
                + jnp.sum(unique.astype(jnp.int32))
            )
        occ = jnp.zeros((batch,), jnp.int32)
        if validity == "packed":
            # encode over a PREFIX of the sorted array with the unique mask:
            # ascending sort pushes every U64_MAX sentinel past the real
            # survivors, so the first min(enc_cap, N) entries hold ALL
            # occurrences whenever occ <= enc_cap (checked exactly via the
            # occ meta column; the retry ladder grows enc_cap otherwise).
            # Bundling is commutative and padding is masked, so this is
            # bit-identical to the full sweep at ~2.5x less encode work —
            # and still avoids compact_masked's per-element scatter, which
            # costs more device time than the prefix sweep saves.
            is_sent = (sorted_h.hi == _SENT) & (sorted_h.lo == _SENT)
            occ = jnp.sum((~is_sent).astype(jnp.int32), axis=-1)
            E = min(enc_cap, sorted_h.hi.shape[-1])
            sh = U64(sorted_h.hi[:, :E], sorted_h.lo[:, :E])
            un = unique[:, :E]
            n_hashes = jnp.sum(un.astype(jnp.int32), axis=-1)
            if probe == "hashes":
                return _hashes_out(sh.hi, sh.lo, un, n_hashes, occ)
            hv32 = encode_hv(sh, un, hv_d, block=encode_block)
        else:
            enc, n_hashes = compact_masked(sorted_h, unique, enc_cap)
            valid = (
                jax.lax.broadcasted_iota(jnp.int32, (batch, enc_cap), 1)
                < n_hashes[:, None]
            )
            if probe == "hashes":
                return _hashes_out(enc.hi, enc.lo, valid, n_hashes, occ)
            hv32 = encode_hv(enc, valid, hv_d, block=encode_block)
        hv16 = hv_to_i16(hv32)
        norm2 = hv_norm2_i32(hv16)
        # single fused output [B, D+10] i16: one D2H transfer per batch,
        # the meta ints ride along bitcast into the hv row tail
        max_count = _norm_max_count(max_count)
        meta = jnp.stack(
            [norm2, n_hashes, max_count, extra_count, occ], axis=-1
        )
        meta16 = jax.lax.bitcast_convert_type(meta, jnp.int16).reshape(
            meta.shape[0], 10
        )
        return jnp.concatenate([hv16, meta16], axis=-1)

    def packed_step(p2w: jnp.ndarray, runs: jnp.ndarray, n_pos: jnp.ndarray):
        cells = packed_cells(C)
        h, pos, valid, cell_max = hash_packed_rows(
            p2w, n_pos, n_chunks, C, k, seed, threshold,
            canonical=canonical, method=method, cells=cells, cap=chunk_cap,
            interpret=interpret,
        )
        # extract FIRST (reduces ~nc*cells*cap slots to ~nb*be_cap entries),
        # then repair invalid-window survivors on the small extracted set.
        # Slot planes have wildly different densities (plane s holds the
        # s-th survivor of each cell: occupancy ~ P(cell count > s)), so
        # plane 0 extracts with small blocks sized for its rate and the
        # near-empty planes 1+ share one cheap pass — extraction cost is
        # O(slots * cap), and splitting cuts it ~5x vs one uniform cap.
        if probe == "hash":
            return jnp.sum(h.lo.astype(jnp.int32)) + jnp.sum(cell_max)
        cap = chunk_cap
        sh = h.hi.reshape(batch, n_chunks, cap, cells)
        sl = h.lo.reshape(batch, n_chunks, cap, cells)
        sp = pos.reshape(batch, n_chunks, cap, cells)
        sv = valid.reshape(batch, n_chunks, cap, cells)
        rest_cap = max(8, packed_be_cap // 4)
        # plane 0 extracts 128-position blocks: a block can never hold more
        # than 128 survivors, so its slot count clamps there (be0 <= 128
        # always, i.e. plane 0 cannot overflow once slots0 == 128). The
        # retry ladder may push packed_be_cap far past 128 purely to grow
        # rest_cap (= be_cap//4, whose 512-slot blocks need up to 512).
        slots0 = min(packed_be_cap, 128)

        def extract(hi, lo, p, v, block, slots):
            hh = U64(hi.reshape(batch, -1), lo.reshape(batch, -1))
            return block_extract(
                hh, v.reshape(batch, -1), block, slots,
                payload=p.reshape(batch, -1),
            )

        flat0, _, be0, pos0 = extract(
            sh[:, :, 0], sl[:, :, 0], sp[:, :, 0], sv[:, :, 0],
            128, slots0,
        )
        if cap > 1:
            rest_n = (cap - 1) * n_chunks * cells
            flatr, _, ber, posr = extract(
                sh[:, :, 1:], sl[:, :, 1:], sp[:, :, 1:], sv[:, :, 1:],
                512 if rest_n % 512 == 0 else 128, rest_cap,
            )
            flat = U64(
                jnp.concatenate([flat0.hi, flatr.hi], axis=1),
                jnp.concatenate([flat0.lo, flatr.lo], axis=1),
            )
            flat_pos = jnp.concatenate([pos0, posr], axis=1)
            # the two extractions have different caps; normalize the rest
            # count into be_cap units so ONE check covers both exactly:
            # ber <= rest_cap  <=>  ber*be_cap//rest_cap <= be_cap
            # (be_cap >= rest_cap always, so overflow strictly exceeds it)
            be_max = jnp.maximum(
                be0, ber * packed_be_cap // rest_cap
            )
        else:
            flat, flat_pos, be_max = flat0, pos0, be0
        if probe == "extract_pre":  # extraction WITHOUT the run postfilter
            return (
                jnp.sum(flat.lo.astype(jnp.int32))
                + jnp.sum(flat_pos) + jnp.sum(be_max)
            )
        clean = filter_positions_by_runs(flat_pos, runs, k)
        flat = U64(
            jnp.where(clean, flat.hi, _SENT),
            jnp.where(clean, flat.lo, _SENT),
        )
        if probe == "extract":
            return jnp.sum(flat.lo.astype(jnp.int32)) + jnp.sum(be_max)
        return _finish(flat, cell_max, be_max)

    def step(packed2: jnp.ndarray, validity_in: jnp.ndarray):
        if validity == "runs":
            shifts2 = np.arange(4, dtype=np.uint8) * 2
            b = (packed2[..., None] >> shifts2) & np.uint8(3)
            b = b.reshape(b.shape[:-2] + (-1,))
            valid = _valid_from_runs(validity_in, L_pad)
            codes = jnp.where(valid, b, np.uint8(INVALID))[:, :L_ext]
        else:
            codes = _unpack_codes(packed2, validity_in)[:, :L_ext]
        # chunk views with k-1 halos -> [B*nc, C + k - 1]
        chunks = jnp.stack(
            [codes[:, c * C : c * C + C + k - 1] for c in range(n_chunks)],
            axis=1,
        ).reshape(batch * n_chunks, C + k - 1)
        h, keep = hash_kmer_positions(
            chunks, k, seed=seed, threshold=threshold,
            canonical=canonical, method=method,
        )
        h = U64(
            h.hi.reshape(batch, n_chunks * C),
            h.lo.reshape(batch, n_chunks * C),
        )
        keep = keep.reshape(batch, n_chunks * C)
        if extract_block:
            flat, _, bc = block_extract(h, keep, extract_block, chunk_cap)
            max_count = bc
        else:
            comp, counts = compact_masked(h, keep, chunk_cap)
            slot = jax.lax.broadcasted_iota(
                jnp.int32, (batch, chunk_cap), 1
            )
            filled = slot < counts[:, None]
            flat = U64(
                jnp.where(filled, comp.hi, _SENT),
                jnp.where(filled, comp.lo, _SENT),
            )
            max_count = counts
        return _finish(flat, max_count, jnp.zeros((batch,), jnp.int32))

    fn = packed_step if validity == "packed" else step
    return jax.jit(fn) if jit_compile else fn


def split_step_output(out: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Fused [B, D+10] i16 step output -> (hv i16 [B, D], meta i32 [B, 5]).

    meta columns: 0 norm2, 1 n_hashes, 2 max survivor count, 3 max
    block-extract count (packed path), 4 total survivor occurrences
    (packed path: checked against enc_cap since the encode sweeps only the
    sorted prefix) / 0 otherwise.
    """
    out = np.asarray(out)
    hv = out[:, :-10]
    meta = np.ascontiguousarray(out[:, -10:]).view(np.int32)
    return hv, meta


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@functools.lru_cache(maxsize=8)
def _concat_outputs_jit(k: int):
    """jit'ed K-way concat: fuses K step outputs into ONE D2H fetch
    (K transfers become one; the concat itself is a trivial copy). Keyed
    by K only — step outputs share one shape across buckets
    ([batch, hv_d + META])."""
    return jax.jit(lambda *xs: jnp.concatenate(xs, axis=0))


@functools.lru_cache(maxsize=16)
def _encode_hashes_jit(hv_d: int, npad: int, encode_block: int):
    """jit'ed final encode for the tiled huge-genome path: the host-merged
    unique survivor list (sentinel-free, first n valid) -> (hv16 [D],
    norm2). Bundling is a commutative sum over hashes, so encoding the
    globally-unioned set in one dispatch is bit-identical to the fused
    step's in-place encode. Keyed by the pow2-padded list length."""

    def f(hi: jnp.ndarray, lo: jnp.ndarray, n: jnp.ndarray):
        valid = (
            jax.lax.broadcasted_iota(jnp.int32, (1, npad), 1) < n
        )
        hv32 = encode_hv(
            U64(hi[None, :], lo[None, :]), valid, hv_d, block=encode_block
        )
        hv16 = hv_to_i16(hv32)
        return hv16[0], hv_norm2_i32(hv16)[0]

    return jax.jit(f)


class Sketcher:
    """Batched, pipelined genome sketcher with bucketed jit compilation.

    Equivalent of the reference sketch orchestrator
    (reference:src/sketch.rs:12-69) with the per-file hot loops on device
    and host I/O overlapped in a thread pool.
    """

    def __init__(
        self,
        params: SketchParams,
        chunk_positions: int = 1 << 17,
        encode_block: int = 512,
        batch: int = 8,
        packed: Optional[bool] = None,
        run_cap: int = 512,
        seqpar_min_chunks: int = 512,
        collect_group: int = 8,
        upload_threads: Optional[int] = None,
    ):
        params.validate()
        self.params = params
        self.C = int(chunk_positions)
        self.encode_block = int(encode_block)
        self.batch = int(batch)
        # fused packed path: unpack+hash+compact in one Pallas kernel, runs
        # repaired by the sparse postfilter (packed=None: backend.caps()
        # decides; the kernel is interpreted off the GPU)
        if packed is None:
            packed = caps().hash_path == "packed"
        self.interpret = caps().interpret
        cells = packed_cells(self.C)
        self.packed_mode = bool(packed) and cells > 0
        lsub = self.C // cells if cells else 0
        # per-thread register slots: survivors per cell ~ Bin(lsub,
        # 1/scaled); at lsub=64, scaled=1500 a count past 4 is ~1e-9 per
        # cell (~5e-4 of production batches retry), past 3 it would be 7%
        self.cell_cap = int(
            min(max(4, -(-8 * lsub // max(params.scaled, 1))), lsub)
        ) if cells else 0
        self.be_cap = packed_be_cap_default(self.C, params.scaled)
        # scatter-free block extraction when survivor density is low enough
        # for a few slots per 512-position block (production scaled)
        if params.scaled >= 400 and self.C % 512 == 0:
            self.extract_block = 512
            self.chunk_cap = 8  # slots per block; overflow-checked
        else:
            self.extract_block = 0
            self.chunk_cap = int(
                max(256, 6 * self.C * 8 // max(params.scaled, 1))
            )
        self.run_cap = int(run_cap)
        # genomes at/above this bucket (in chunks) shard their chunk axis
        # over the device mesh instead of batching (sequence parallelism;
        # 512 chunks at the default C is ~67 Mbp — far beyond any one
        # dispatch bucket worth batching)
        self.seqpar_min_chunks = int(seqpar_min_chunks)
        # D2H fetch fusion width for collect_batches (1 disables fusion)
        self.collect_group = max(int(collect_group), 1)
        self._steps: Dict[Tuple, object] = {}
        self._steps_lock = threading.Lock()
        # per-BUCKET encode-cap growth: one repeat-rich outlier genome must
        # not recompile and permanently inflate every other bucket's step
        self._enc_overflow_factor: Dict[int, int] = {}
        self._pack_pool = ThreadPoolExecutor(max_workers=min(self.batch, 8))
        # dedicated uploader: ONE background thread packs and dispatches
        # batches while the main thread parses and collects.
        # 0 = synchronous dispatch (debug/comparison).
        if upload_threads is None:
            upload_threads = int(os.environ.get("HG_UPLOAD_THREADS", "1"))
        self.upload_threads = int(upload_threads)
        self._upload_pool = (
            ThreadPoolExecutor(max_workers=1) if self.upload_threads else None
        )
        self.last_stage_times: Dict[str, float] = {}
        self.last_h2d_bytes = 0

    # -- device step management ------------------------------------------

    def _enc_cap(self, n_chunks: int) -> int:
        # occ ~ Binomial(n_pos, 1/scaled) plus repeat-kmer occurrence
        # duplicates: 2x mean + 512 is mean + (mean+512) of slack — far past
        # any Gaussian tail and ~2x occurrence duplication — while the
        # packed path's encode sweep cost is proportional to this cap
        # (it encodes the sorted-array prefix). The exact occ check + retry
        # ladder makes an undersized cap a recompile, never wrong output.
        cap = self._enc_cap_base(n_chunks)
        cap *= self._enc_overflow_factor.get(n_chunks, 1)
        return int(-(-cap // 256) * 256)

    def _enc_cap_base(self, n_chunks: int) -> int:
        expected = n_chunks * self.C // max(self.params.scaled, 1)
        return 2 * expected + 512

    def _get_step(self, n_chunks: int, chunk_cap: Optional[int] = None,
                  validity: str = "runs", be_cap: Optional[int] = None,
                  probe: Optional[str] = None, rows: Optional[int] = None):
        p = self.params
        rows = rows or self.batch
        if chunk_cap:
            cap = chunk_cap
        elif validity == "packed":
            cap = self.cell_cap
        elif self.extract_block:
            cap = self.chunk_cap
        else:  # scatter path: cap covers the whole genome's survivors
            cap = max(
                self.chunk_cap,
                -(-6 * n_chunks * self.C // max(p.scaled, 1) // 256) * 256,
            )
        be = be_cap or self.be_cap
        key = (
            n_chunks, cap, self._enc_cap(n_chunks), validity, be, probe, rows,
        )
        with self._steps_lock:
            step = self._steps.get(key)
        if step is not None:
            return step, cap, key[2], be
        step = make_sketch_step(
            ksize=p.ksize,
            seed=p.seed,
            threshold=p.threshold,
            hv_d=p.hv_d,
            batch=rows,
            n_chunks=n_chunks,
            chunk_positions=self.C,
            chunk_cap=cap,
            enc_cap=key[2],
            canonical=p.canonical,
            method=p.sketch_method,
            encode_block=self.encode_block,
            extract_block=self.extract_block,
            validity=validity,
            interpret=self.interpret,
            packed_be_cap=be,
            probe=probe,
        )
        with self._steps_lock:
            # a racing thread may have built the same key; keep one so every
            # caller shares the same jit cache entry
            step = self._steps.setdefault(key, step)
        return step, cap, key[2], be

    def _bucket(self, L: int) -> int:
        n_pos = max(L - self.params.ksize + 1, 1)
        return _next_pow2(-(-n_pos // self.C))

    def _prepare_batch(self, genomes: List["PackedGenome"], n_chunks: int,
                       rows: Optional[int] = None):
        """Assemble bucket-padded device inputs from parse-time PackedGenomes.

        Genomes arrive already 2-bit packed with their full invalid-run
        lists (one fused native pass per file, io.fastx.read_genome_packed);
        this only pads rows to the bucket length and adjusts the tail run.
        Falls back to a dense validity bitmask when a genome's run list
        exceeds run_cap (never drops data).

        rows: device batch rows to assemble (default self.batch). Partial
        flush groups dispatch with rows = next_pow2(len(genomes)): padding
        rows are pure upload bytes and device work, so a 3-genome straggler
        must not ship a 16-row buffer (at most log2(batch)+1 step programs
        per bucket ever compile).

        Returns (validity_mode, *step_args).
        """
        k = self.params.ksize
        rows = rows or self.batch
        if self.packed_mode and all(
            g.runs.shape[0] <= self.run_cap for g in genomes
        ):
            # fused packed path: u32 words + raw run lists + k-mer counts
            W = packed_row_words(n_chunks, self.C)
            buf = np.zeros((rows, W * 4), dtype=np.uint8)
            runs = np.full(
                (rows, self.run_cap, 2), np.int32(0x7FFFFFFF),
                dtype=np.int32,
            )
            n_pos = np.zeros(rows, dtype=np.int32)
            for i, g in enumerate(genomes):
                nb = min(g.packed2.shape[0], W * 4)
                buf[i, :nb] = g.packed2[:nb]
                runs[i, : g.runs.shape[0]] = g.runs
                n_pos[i] = max(g.length - k + 1, 0)
            return "packed", buf.view(np.uint32), runs, n_pos
        L_ext = n_chunks * self.C + k - 1
        L_pad = -(-L_ext // 8) * 8
        adj: List[np.ndarray] = []
        for g in genomes:
            r = g.runs
            n = min(g.length, L_pad)
            if n < L_pad:  # merge/append the tail-padding run
                if r.shape[0] and r[-1, 1] >= n:
                    r = r.copy()
                    r[-1, 1] = L_pad
                else:
                    r = np.concatenate(
                        [r, np.array([[n, L_pad]], np.int32)]
                    )
            adj.append(r)
        p2 = np.zeros((rows, L_pad // 4), dtype=np.uint8)
        for i, g in enumerate(genomes):
            p2[i, : g.packed2.shape[0]] = g.packed2
        if max(r.shape[0] for r in adj) <= self.run_cap:
            runs = np.zeros((rows, self.run_cap, 2), dtype=np.int32)
            # Mark ONLY rows beyond the real batch fully invalid.  Seeding
            # every row and relying on real genomes to overwrite silently
            # emptied any genome with an empty adjusted run list (reachable
            # when g.length == L_pad, i.e. (ksize-1) % 8 == 0 and the genome
            # exactly fills its bucket): zero rows written -> row stayed
            # marked invalid -> n_hashes=0 with no error (r2 verdict bug).
            runs[len(adj):, 0, 1] = L_pad
            for i, r in enumerate(adj):
                runs[i, : r.shape[0]] = r
            return "runs", p2, runs
        pv = np.zeros((rows, L_pad // 8), dtype=np.uint8)
        for i, (g, r) in enumerate(zip(genomes, adj)):
            valid = np.zeros(L_pad, dtype=bool)
            valid[: min(g.length, L_pad)] = True
            for s, e in r:
                valid[s:e] = False
            pv[i] = np.packbits(valid, bitorder="little")
        return "mask", p2, pv

    # -- public API --------------------------------------------------------

    def submit_batch_packed(self, genomes: List["PackedGenome"]):
        """Dispatch up to `batch` same-bucket PackedGenomes in one call.

        Partial groups dispatch with next-pow2 device rows: padding rows
        are real upload bytes and device work, so a straggler flush must
        not ship a full-batch buffer (waste < 2x, at most log2(batch)+1
        row variants per bucket compile)."""
        if not 1 <= len(genomes) <= self.batch:
            raise ValueError(f"batch size must be in [1, {self.batch}]")
        n_chunks = max(self._bucket(g.length) for g in genomes)
        rows = min(self.batch, _next_pow2(len(genomes)))
        mode, *args = self._prepare_batch(genomes, n_chunks, rows=rows)
        step, cap, enc_cap, be_cap = self._get_step(
            n_chunks, validity=mode, rows=rows
        )
        out = step(*(jnp.asarray(a) for a in args))
        return {
            "out": out,
            "n": len(genomes),
            "rows": rows,
            "args": args,
            "n_chunks": n_chunks,
            "cap": cap,
            "enc_cap": enc_cap,
            "be_cap": be_cap,
            "validity": mode,
            "h2d_bytes": sum(a.nbytes for a in args),
        }

    def submit_batch(self, codes_list: List[np.ndarray]):
        """Dispatch up to `batch` same-bucket genomes given flat code arrays.

        Packing happens host-side here (thread pool); the production read
        path (sketch_files) parses straight into PackedGenomes instead.
        """
        from hypergen_tpu.io.fastx import packed_from_codes

        if len(codes_list) > 1:  # numpy releases the GIL; pack in parallel
            genomes = list(self._pack_pool.map(packed_from_codes, codes_list))
        else:
            genomes = [packed_from_codes(codes_list[0])]
        return self.submit_batch_packed(genomes)

    def collect_batch(self, handle) -> List[Dict[str, object]]:
        """Realize a batch; retries exactly on capacity overflow (rare)."""
        return self.collect_batches([handle])[0]

    def collect_batches(self, handles) -> List[List[Dict[str, object]]]:
        """Realize several in-flight batches with ONE fused D2H fetch.

        Device-side concat of the K step outputs -> single device_get ->
        host split; per-batch capacity checks/retries run on the slices
        (retries are rare and refetch individually). Groups larger than
        collect_group chunk; partial chunks pad by repeating the last
        output up to the next POWER OF TWO, so at most log2(G)+1 concat
        programs ever compile while padding waste stays under 2x (padding
        a 2-batch chunk to a fixed G=8 would quadruple every fetch)."""
        results: List[List[Dict[str, object]]] = []
        G = max(int(getattr(self, "collect_group", 4)), 1)
        for lo in range(0, len(handles), G):
            chunk = handles[lo : lo + G]
            outs = [h["out"] for h in chunk]
            if len(outs) == 1:
                fetched = [np.asarray(jax.device_get(outs[0]))]
            else:
                K = _next_pow2(len(outs))
                padded = outs + [outs[-1]] * (K - len(outs))
                big = np.asarray(
                    jax.device_get(_concat_outputs_jit(K)(*padded))
                )
                # row counts can differ per handle (partial flush groups
                # dispatch next-pow2 rows): split by cumulative offsets
                offs = np.cumsum([0] + [o.shape[0] for o in outs])
                fetched = [
                    big[offs[i] : offs[i + 1]] for i in range(len(outs))
                ]
            results.extend(
                self._finalize_batch(h, o) for h, o in zip(chunk, fetched)
            )
        return results

    def _finalize_batch(self, handle, out_np) -> List[Dict[str, object]]:
        hv, meta = split_step_output(out_np)
        n = handle["n"]
        mode = handle["validity"]
        cells = packed_cells(self.C)
        lsub = self.C // cells if cells else 0

        def counts():
            # meta cols: 0 norm2, 1 n_hashes, 2 slot/cell max, 3 be max,
            # 4 occurrence count (packed)
            return (
                int(np.max(meta[:n, 2])) if n else 0,
                int(np.max(meta[:n, 3])) if n else 0,
                meta[:n, 1],
                int(np.max(meta[:n, 4])) if n else 0,
            )

        chunk_cap, be_cap, enc_cap = (
            handle["cap"], handle["be_cap"], handle["enc_cap"]
        )
        for attempt in range(7):
            max_count, be_max, n_hashes, occ_max = counts()
            # packed encodes a sorted-array prefix of enc_cap entries: the
            # bound is on total occurrences, not unique hashes
            ok = (
                max_count <= chunk_cap
                and (
                    occ_max <= enc_cap if mode == "packed"
                    else int(n_hashes.max(initial=0)) <= enc_cap
                )
                and (mode != "packed" or be_max <= be_cap)
            )
            if ok:
                return [
                    {
                        "hv": hv[i],
                        "norm2": int(meta[i, 0]),
                        "n_hashes": int(n_hashes[i]),
                    }
                    for i in range(n)
                ]
            # grow whichever capacity overflowed STRAIGHT to a sufficient
            # size (each retry costs a fresh compile, so doubling loops
            # cost real time) and recompute this batch synchronously (host
            # inputs are reused from the handle)
            if max_count > chunk_cap:
                log.warning(
                    "survivor cap overflow (%d > %d); retrying",
                    max_count, chunk_cap,
                )
                grown = _next_pow2(max_count)
                chunk_cap = (
                    min(grown, lsub) if mode == "packed" else grown
                )
            if mode == "packed" and be_max > be_cap:
                log.warning(
                    "extract cap overflow (%d > %d); retrying",
                    be_max, be_cap,
                )
                # be_max is in be_cap units (rest overflow is normalized as
                # ber*be_cap//rest_cap), so be_cap >= be_max restores
                # rest_cap >= ber; 2048 = 4x the 512-slot rest block size,
                # past which overflow is impossible (see slots0 note in
                # make_sketch_step)
                be_cap = min(max(be_cap * 2, _next_pow2(be_max)), 2048)
            enc_over = (
                occ_max if mode == "packed"
                else int(n_hashes.max(initial=0))
            )
            if enc_over > enc_cap:
                log.warning(
                    "encode cap overflow (%d > %d); retrying",
                    enc_over, enc_cap,
                )
                base = self._enc_cap_base(handle["n_chunks"])
                need = -(-enc_over // max(base, 1))
                self._enc_overflow_factor[handle["n_chunks"]] = max(
                    self._enc_overflow_factor.get(handle["n_chunks"], 1) * 2,
                    _next_pow2(need),
                )
            step, chunk_cap, enc_cap, be_cap = self._get_step(
                handle["n_chunks"], chunk_cap, validity=mode, be_cap=be_cap,
                rows=handle.get("rows"),
            )
            hv, meta = split_step_output(
                jax.device_get(
                    step(*(jnp.asarray(a) for a in handle["args"]))
                )
            )
        raise RuntimeError("sketcher capacity retry limit exceeded")

    def submit(self, codes: np.ndarray):
        return self.submit_batch([codes])

    def collect(self, handle) -> Dict[str, object]:
        return self.collect_batch(handle)[0]

    def sketch_codes(self, codes: np.ndarray) -> Dict[str, object]:
        """Sketch one genome given flat base codes (synchronous)."""
        return self.collect(self.submit(codes))

    def _to_filesketch(self, res: Dict[str, object], name: str) -> FileSketch:
        p = self.params
        if p.if_compressed:
            return FileSketch.from_dense(
                res["hv"], res["norm2"], name, p.ksize, p.scaled,
                p.canonical, p.seed,
            )
        # quant_bits 0 marks a dense (uncompressed) record; 16 would collide
        # with the packed b=16 layout and corrupt on decompress
        return FileSketch(
            ksize=p.ksize, scaled=p.scaled, canonical=p.canonical, seed=p.seed,
            hv_d=p.hv_d, hv_quant_bits=0, hv_norm_2=res["norm2"],
            file_str=name, hv=np.asarray(res["hv"], dtype=np.int16),
        )

    def sketch_file(self, path) -> FileSketch:
        g = read_genome_packed(path)
        res = self.collect_batch(self.submit_batch_packed([g]))[0]
        return self._to_filesketch(res, str(path))

    # -- single-device huge genomes: bounded fixed-shape tiling -------------

    def _tile_genome(self, g: "PackedGenome", tile_chunks: int):
        """Split a PackedGenome into fixed-shape tiles of tile_chunks
        chunks, each covering a disjoint k-mer start range [t*TC, (t+1)*TC)
        plus the k-1 halo. Tile t's PackedGenome has length
        n_pos_tile + k - 1, byte-aligned packed2 slice (TC % 4 == 0), and
        its parent runs clipped/shifted into tile coordinates."""
        k = self.params.ksize
        TC = tile_chunks * self.C
        total_pos = max(g.length - k + 1, 0)
        n_tiles = max(-(-total_pos // TC), 1)
        tiles = []
        for t in range(n_tiles):
            start = t * TC
            n_pos_t = min(total_pos - start, TC)
            L_t = n_pos_t + k - 1
            b0 = start // 4
            p2 = g.packed2[b0 : b0 + -(-L_t // 4)]
            lo = np.minimum(np.maximum(g.runs[:, 0] - start, 0), L_t)
            hi = np.minimum(np.maximum(g.runs[:, 1] - start, 0), L_t)
            keep = hi > lo
            runs_t = np.stack(
                [lo[keep], hi[keep]], axis=-1
            ).astype(np.int32)
            tiles.append(PackedGenome(p2, runs_t, L_t))
        return tiles

    def sketch_packed_tiled(
        self, g: "PackedGenome", tile_chunks: int = 64
    ) -> Dict[str, object]:
        """Sketch ONE huge genome on ONE device in bounded memory.

        On a single device a >= seqpar_min_chunks genome would otherwise
        compile a giant one-shot bucket (multi-GB temporaries and a fresh
        compile per pow2 bucket). Instead: stream
        fixed-shape tiles (batched `batch` per dispatch) through the
        probe="hashes" step, union the per-tile survivor hash sets on the
        host (dedup composes as set union across tiles), and encode the
        global set in one dispatch (bundling is a sum) — bit-identical to
        the one-shot step, asserted in tests/test_tiled_huge.py. Memory is
        O(batch * tile_chunks * C) device-side and O(survivors) host-side.
        The reference handles arbitrary length with the same chunk+halo
        decomposition on one GPU (reference:src/cuda_kernel.cu:31,39-40).
        """
        k = self.params.ksize
        tiles = self._tile_genome(g, tile_chunks)
        all_hashes: List[np.ndarray] = []
        for lo in range(0, len(tiles), self.batch):
            group = tiles[lo : lo + self.batch]
            all_hashes.extend(self._tile_group_hashes(group, tile_chunks))
        if all_hashes:
            merged = np.unique(np.concatenate(all_hashes))
        else:
            merged = np.zeros(0, dtype=np.uint64)
        n = merged.shape[0]
        npad = max(_next_pow2(n), 256)
        buf = np.full(npad, np.uint64(0xFFFFFFFFFFFFFFFF), dtype=np.uint64)
        buf[:n] = merged
        hv16, norm2 = jax.device_get(
            _encode_hashes_jit(self.params.hv_d, npad, self.encode_block)(
                jnp.asarray((buf >> np.uint64(32)).astype(np.uint32)),
                jnp.asarray((buf & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
                jnp.int32(n),
            )
        )
        return {
            "hv": np.asarray(hv16), "norm2": int(norm2), "n_hashes": n,
        }

    def _tile_group_hashes(
        self, group: List["PackedGenome"], tile_chunks: int
    ) -> List[np.ndarray]:
        """Run one batched probe="hashes" dispatch over up to `batch`
        tiles; returns each tile's unique survivor hashes as host uint64.
        Capacity overflows retry exactly like _finalize_batch."""
        rows = min(self.batch, _next_pow2(len(group)))
        mode, *args = self._prepare_batch(group, tile_chunks, rows=rows)
        step, chunk_cap, enc_cap, be_cap = self._get_step(
            tile_chunks, validity=mode, probe="hashes", rows=rows
        )
        out = np.asarray(
            jax.device_get(step(*(jnp.asarray(a) for a in args)))
        )
        cells = packed_cells(self.C)
        lsub = self.C // cells if cells else 0
        for attempt in range(7):
            meta = out[:, -5:]
            n = len(group)
            max_count = int(np.max(meta[:n, 2])) if n else 0
            be_max = int(np.max(meta[:n, 3])) if n else 0
            occ_max = int(np.max(meta[:n, 4])) if n else 0
            n_hash_max = int(np.max(meta[:n, 1])) if n else 0
            ok = (
                max_count <= chunk_cap
                and (
                    occ_max <= enc_cap if mode == "packed"
                    else n_hash_max <= enc_cap
                )
                and (mode != "packed" or be_max <= be_cap)
            )
            if ok:
                E = (out.shape[1] - 5) // 2
                res = []
                for i in range(n):
                    hi = out[i, :E].view(np.uint32).astype(np.uint64)
                    lo = out[i, E : 2 * E].view(np.uint32).astype(np.uint64)
                    h = (hi << np.uint64(32)) | lo
                    res.append(h[h != np.uint64(0xFFFFFFFFFFFFFFFF)])
                return res
            if max_count > chunk_cap:
                grown = _next_pow2(max_count)
                chunk_cap = min(grown, lsub) if mode == "packed" else grown
            if mode == "packed" and be_max > be_cap:
                be_cap = min(max(be_cap * 2, _next_pow2(be_max)), 2048)
            enc_over = occ_max if mode == "packed" else n_hash_max
            if enc_over > enc_cap:
                base = self._enc_cap_base(tile_chunks)
                need = -(-enc_over // max(base, 1))
                self._enc_overflow_factor[tile_chunks] = max(
                    self._enc_overflow_factor.get(tile_chunks, 1) * 2,
                    _next_pow2(need),
                )
            step, chunk_cap, enc_cap, be_cap = self._get_step(
                tile_chunks, chunk_cap, validity=mode, be_cap=be_cap,
                probe="hashes", rows=rows,
            )
            out = np.asarray(
                jax.device_get(step(*(jnp.asarray(a) for a in args)))
            )
        raise RuntimeError("tiled sketch capacity retry limit exceeded")

    def sketch_files(
        self,
        paths: Sequence,
        progress: bool = True,
        pipeline_depth: int = 3,
        io_threads: int = 0,
        read_ahead: int = 0,
    ) -> List[FileSketch]:
        """Sketch many genomes: batched dispatches, pipelined, I/O threaded.

        Genomes stream through a bounded read-ahead window (default 8x
        batch): same-bucket genomes within the window are grouped into
        batches of `batch`, and up to pipeline_depth + collect_group - 1
        device batches are in flight (collection waits until collect_group
        outputs can be fetched as ONE fused D2H transfer; set
        collect_group=1 on the Sketcher to recover the strict
        pipeline_depth bound). Peak RAM is O(read_ahead + in-flight)
        genomes regardless of directory size. Output order matches input
        order (reference emits files in glob order,
        reference:src/sketch.rs:19-32).
        """
        import os

        from hypergen_tpu.utils.progress import ProgressBar
        from hypergen_tpu.utils.timing import StageTimer

        paths = list(paths)
        pb = ProgressBar(len(paths), enabled=progress)
        io_threads = io_threads or min(self.params.threads, 16)
        read_ahead = read_ahead or max(8 * self.batch, 2 * io_threads)
        results: Dict[int, FileSketch] = {}
        window = collections.deque()
        timer = StageTimer()
        h2d_bytes = 0

        def drain_group():
            # fuse up to collect_group in-flight outputs into ONE D2H fetch
            # (see collect_batches)
            nonlocal h2d_bytes
            group = [
                window.popleft()
                for _ in range(min(self.collect_group, len(window)))
            ]
            # resolve uploader futures first: "upload_wait" is time the
            # main thread stalls on the background H2D feeder
            with timer.stage("upload_wait"):
                group = [
                    (idxs, h.result() if hasattr(h, "result") else h)
                    for idxs, h in group
                ]
            h2d_bytes += sum(h["h2d_bytes"] for _, h in group)
            # "collect" is the wait for the device pipeline of these
            # batches plus their fused D2H fetch
            with timer.stage("collect"):
                batches = self.collect_batches([h for _, h in group])
            with timer.stage("compress"):
                for (idxs, _), res_list in zip(group, batches):
                    for i, res in zip(idxs, res_list):
                        results[i] = self._to_filesketch(res, str(paths[i]))
                        pb.inc()

        def dispatch(group):
            # hand the batch to the dedicated uploader thread, which
            # packs and dispatches while this thread parses/buckets/
            # collects. The window bounds queued-but-unfetched batches
            # (memory stays O(window * batch) PackedGenomes).
            idxs = [i for i, _ in group]
            genomes = [g for _, g in group]
            with timer.stage("pack+dispatch"):
                if self._upload_pool is not None:
                    handle = self._upload_pool.submit(
                        self.submit_batch_packed, genomes
                    )
                else:
                    handle = self.submit_batch_packed(genomes)
                window.append((idxs, handle))
            if len(window) >= pipeline_depth + self.collect_group - 1:
                drain_group()

        # stream files through a bounded read-ahead window so a 50k-file
        # directory never materializes in RAM (PackedGenomes are 4x smaller
        # than code arrays); same-bucket genomes within the window group
        # into full batches, stragglers flush at the end
        by_bucket: Dict[int, List[Tuple[int, PackedGenome]]] = {}
        with ThreadPoolExecutor(max_workers=io_threads) as pool:
            pending = collections.deque()  # (idx, future) in input order
            it = iter(range(len(paths)))

            def fill():
                while len(pending) < read_ahead:
                    i = next(it, None)
                    if i is None:
                        return
                    pending.append(
                        (i, pool.submit(read_genome_packed, paths[i]))
                    )

            fill()
            while pending:
                i, fut = pending.popleft()
                with timer.stage("fasta_read"):
                    g = fut.result()
                fill()
                bucket = self._bucket(g.length)
                if bucket >= self.seqpar_min_chunks:
                    if jax.device_count() > 1:
                        # huge genome: shard its chunk axis over the mesh
                        # instead of monopolizing a giant batched bucket
                        from hypergen_tpu.io.fastx import codes_from_packed
                        from hypergen_tpu.parallel.seqpar import (
                            sketch_codes_seqpar,
                        )

                        res = sketch_codes_seqpar(
                            codes_from_packed(g), self.params,
                            chunk_positions=self.C,
                            encode_block=self.encode_block,
                        )
                    else:
                        # single device: stream fixed-shape tiles with a
                        # host survivor-set merge instead of compiling a
                        # giant one-shot bucket
                        res = self.sketch_packed_tiled(
                            g,
                            tile_chunks=max(1, self.seqpar_min_chunks // 8),
                        )
                    results[i] = self._to_filesketch(res, str(paths[i]))
                    pb.inc()
                    continue
                by_bucket.setdefault(bucket, []).append((i, g))
                if len(by_bucket[bucket]) >= self.batch:
                    dispatch(by_bucket.pop(bucket))
            for bucket in sorted(by_bucket):  # flush partial groups
                for j in range(0, len(by_bucket[bucket]), self.batch):
                    dispatch(by_bucket[bucket][j : j + self.batch])
            while window:
                drain_group()
        pb.finish()
        # keep the stage totals readable by callers (bench reports shares)
        self.last_stage_times = dict(timer.totals)
        self.last_h2d_bytes = h2d_bytes
        if os.environ.get("HG_STAGE_TIMING"):
            log.info("sketch stage timing:\n%s", timer.report())
        return [results[i] for i in range(len(paths))]
