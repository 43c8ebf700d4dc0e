"""Fused packed sketch kernel parity vs. the XLA path.

Off the GPU the kernel runs in Pallas interpret mode, which pins its
semantics in CI; `gpu`-marked tests compare the compiled kernel on the
card with the same references.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hypergen_tpu.ops import u64 as u
from hypergen_tpu.ops.kmers import hash_kmer_positions
from hypergen_tpu.ops.pallas.hash_kernel import hash_packed_rows, packed_cells
from hypergen_tpu.params import fracminhash_threshold

rng = np.random.default_rng(5)


def _kernel_survivors(codes, k, seed, thr, method="t1ha2", canonical=True,
                      cells=0, interpret=True, cap=0):
    """Per-row sorted (pos, hash) survivors of the packed kernel over
    one-chunk rows codes [R, C + k - 1], after the exact invalid-run
    postfilter the sketch step applies."""
    R, width = codes.shape
    C = width - (k - 1)
    p2w, _, npos = _packed_inputs(list(codes), 1, C, k)
    cap = cap or C // (cells or packed_cells(C))  # lsub: never overflows
    h, pos, valid, cell_max = hash_packed_rows(
        jnp.asarray(p2w), jnp.asarray(npos), 1, C, k, seed, thr,
        canonical=canonical, method=method, interpret=interpret,
        cells=cells, cap=cap,
    )
    assert (np.asarray(cell_max) <= cap).all()
    hv, pos, valid = u.to_np_u64(h), np.asarray(pos), np.asarray(valid)
    # invalid bases per window from a prefix count of the codes
    n_bad = np.concatenate(
        [np.zeros((R, 1), np.int64), np.cumsum(codes >= 4, axis=1)], axis=1
    )
    out = []
    for b in range(R):
        p = np.where(valid[b], pos[b], 0)
        keep = valid[b] & (n_bad[b][p + k] == n_bad[b][p])
        order = np.argsort(pos[b][keep], kind="stable")
        out.append((pos[b][keep][order], hv[b][keep][order]))
    return out


def _check(codes, k, seed, thr, method="t1ha2", canonical=True, cells=0,
           interpret=True, cap=0):
    """Kernel survivors == XLA keep positions and hashes, row by row."""
    h_ref, keep_ref = hash_kmer_positions(
        jnp.asarray(codes), k, seed, thr, canonical=canonical, method=method
    )
    keep_ref = np.asarray(keep_ref)
    h_ref = u.to_np_u64(h_ref)
    got = _kernel_survivors(codes, k, seed, thr, method, canonical, cells,
                            interpret=interpret, cap=cap)
    for b, (pos, hv) in enumerate(got):
        np.testing.assert_array_equal(pos, np.flatnonzero(keep_ref[b]))
        np.testing.assert_array_equal(hv, h_ref[b][keep_ref[b]])
    return int(keep_ref.sum())


@pytest.mark.parametrize("k", [8, 15, 16, 21, 31])
def test_kernel_parity_k(k):
    codes = rng.integers(0, 5, size=(2, 2048 + k - 1)).astype(np.uint8)
    codes[1] = rng.integers(0, 4, size=2048 + k - 1)  # one junk-free row
    n = _check(codes, k, 7, fracminhash_threshold(2))
    assert n > 0


def test_kernel_parity_mmhash():
    codes = rng.integers(0, 5, size=(2, 2068)).astype(np.uint8)
    _check(codes, 21, 123, fracminhash_threshold(2), method="mmhash")


def test_kernel_parity_noncanonical():
    codes = rng.integers(0, 4, size=(1, 2068)).astype(np.uint8)
    _check(codes, 21, 123, fracminhash_threshold(1), canonical=False)


def test_kernel_all_invalid():
    codes = np.full((1, 2068), 4, dtype=np.uint8)
    n = _check(codes, 21, 123, fracminhash_threshold(1))
    assert n == 0


def test_kernel_multi_lsub():
    """lsub > 16: windows crossing cell boundaries via the halo, cells
    reading several packed words each."""
    codes = rng.integers(0, 5, size=(1, 4096 + 20)).astype(np.uint8)
    _check(codes, 21, 123, fracminhash_threshold(2), cells=128)


def test_kernel_rejects_bad_width():
    with pytest.raises(ValueError):
        hash_packed_rows(
            jnp.zeros((1, 100), jnp.uint32), jnp.zeros((1,), jnp.int32),
            1, 1000, 21, 123, 100, interpret=True,
        )


def _packed_inputs(genomes, nc, C, k):
    """Host packing for hash_packed_rows from flat code arrays."""
    from hypergen_tpu.io.fastx import packed_from_codes
    from hypergen_tpu.models.sketcher import packed_row_words

    B = len(genomes)
    W = packed_row_words(nc, C)
    p2w = np.zeros((B, W * 4), np.uint8)
    runs_list, npos = [], np.zeros(B, np.int32)
    for b, codes in enumerate(genomes):
        g = packed_from_codes(codes)
        nb = min(g.packed2.shape[0], W * 4)
        p2w[b, :nb] = g.packed2[:nb]
        runs_list.append(g.runs)
        npos[b] = max(g.length - k + 1, 0)
    return p2w.view(np.uint32), runs_list, npos


def test_packed_kernel_parity():
    """Fused packed kernel + run postfilter == XLA path hash sets.

    Covers: genomes shorter than the bucket (pos_end masking of the all-'A'
    padding tail), interior N runs (optimistic hash + exact repair), and
    per-cell slot compaction."""
    k, seed, thr = 21, 123, fracminhash_threshold(3)
    C, nc, cells, cap = 2048, 2, 128, 16
    n_posL = [nc * C - 777, C + 5]
    genomes = []
    for b in range(2):
        L = n_posL[b] + k - 1
        codes = rng.integers(0, 4, size=L).astype(np.uint8)
        for _ in range(5):
            s = int(rng.integers(0, L - 50))
            codes[s : s + int(rng.integers(1, 40))] = 4
        genomes.append(codes)

    p2w, runs_list, npos = _packed_inputs(genomes, nc, C, k)
    h, pos, valid, cell_max = hash_packed_rows(
        jnp.asarray(p2w), jnp.asarray(npos), nc, C, k, seed, thr,
        interpret=True, cells=cells, cap=cap,
    )
    hi, lo = np.asarray(h.hi), np.asarray(h.lo)
    pos, valid = np.asarray(pos), np.asarray(valid)
    assert (np.asarray(cell_max) <= cap).all()
    for b, codes in enumerate(genomes):
        # reference: XLA path over the same bucket layout
        L_ext = nc * C + k - 1
        buf = np.full(L_ext, 4, np.uint8)
        buf[: min(len(codes), L_ext)] = codes[:L_ext]
        chunks = np.stack([buf[c * C : c * C + C + k - 1] for c in range(nc)])
        h_ref, keep_ref = hash_kmer_positions(
            jnp.asarray(chunks), k, seed, thr
        )
        want = set(u.to_np_u64(h_ref)[np.asarray(keep_ref)].tolist())
        # postfilter spec: window [p, p+k) must not intersect any run
        hv = (hi[b].astype(np.uint64) << np.uint64(32)) | lo[b].astype(
            np.uint64
        )
        keep = valid[b].copy()
        for i in np.flatnonzero(valid[b]):
            p = pos[b, i]
            for s, e in runs_list[b]:
                if s < p + k and e > p:
                    keep[i] = False
                    break
        assert set(hv[keep].tolist()) == want


@pytest.mark.parametrize(
    "unroll",
    [4, 5, pytest.param(13, marks=pytest.mark.slow)],
)
def test_packed_kernel_unroll_bit_identical(unroll):
    """Loop unrolling is a pure scheduling change: every output array must be
    bit-identical to unroll=1, including the main-loop fori_loop tail when
    lsub % unroll != 0 (here lsub=16, so 5 exercises a 1-position tail
    cheaply, 13 a 3-position tail — slow lane — and 4 a full-trip count
    with no tail)."""
    k, seed, thr = 21, 123, fracminhash_threshold(3)
    C, nc, cells, cap = 2048, 1, 128, 16
    codes = rng.integers(0, 4, size=nc * C + k - 1).astype(np.uint8)
    codes[900:950] = 4
    p2w, _, npos = _packed_inputs([codes], nc, C, k)
    outs = []
    for ur in (1, unroll):
        h, pos, valid, cell_max = hash_packed_rows(
            jnp.asarray(p2w), jnp.asarray(npos), nc, C, k, seed, thr,
            interpret=True, cells=cells, cap=cap, unroll=ur,
        )
        outs.append((np.asarray(h.hi), np.asarray(h.lo), np.asarray(pos),
                     np.asarray(valid), np.asarray(cell_max)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method,canonical", [("mmhash", True), ("t1ha2", False)])
def test_packed_kernel_parity_variants(method, canonical):
    k, seed, thr = 21, 123, fracminhash_threshold(3)
    C, nc, cells, cap = 2048, 1, 128, 16
    codes = rng.integers(0, 4, size=C + k - 1 + 300).astype(np.uint8)
    codes[500:540] = 4
    p2w, runs_list, npos = _packed_inputs([codes], nc, C, k)
    h, pos, valid, cell_max = hash_packed_rows(
        jnp.asarray(p2w), jnp.asarray(npos), nc, C, k, seed, thr,
        canonical=canonical, method=method, interpret=True,
        cells=cells, cap=cap,
    )
    hi, lo = np.asarray(h.hi), np.asarray(h.lo)
    pos, valid = np.asarray(pos), np.asarray(valid)
    assert int(np.asarray(cell_max)[0]) <= cap
    buf = np.full(C + k - 1, 4, np.uint8)
    buf[: C + k - 1] = codes[: C + k - 1]
    h_ref, keep_ref = hash_kmer_positions(
        jnp.asarray(buf[None, :]), k, seed, thr,
        canonical=canonical, method=method,
    )
    want = set(u.to_np_u64(h_ref)[np.asarray(keep_ref)].tolist())
    hv = (hi[0].astype(np.uint64) << np.uint64(32)) | lo[0].astype(np.uint64)
    keep = valid[0].copy()
    for i in np.flatnonzero(valid[0]):
        p = pos[0, i]
        for s, e in runs_list[0]:
            if s < p + k and e > p:
                keep[i] = False
                break
    assert set(hv[keep].tolist()) == want
    assert len(want) > 0


def test_packed_step_parity_and_retry():
    """Sketcher packed path == XLA runs path bit-exactly, through the
    capacity retry ladder (scaled=50 stresses cell and extract caps)."""
    from hypergen_tpu.io.fastx import INVALID
    from hypergen_tpu.models.sketcher import Sketcher
    from hypergen_tpu.params import SketchParams

    r2 = np.random.default_rng(11)
    p = SketchParams(scaled=50)
    genomes = []
    for L in (5000, 2047, 100):
        codes = r2.integers(0, 4, size=L).astype(np.uint8)
        for _ in range(3):
            s = int(r2.integers(0, max(L - 50, 1)))
            codes[s : s + int(r2.integers(1, 40))] = INVALID
        genomes.append(codes)
    genomes.append(np.full(30, INVALID, np.uint8))  # all-N genome

    ref = Sketcher(p, chunk_positions=2048, batch=len(genomes),
                   packed=False)
    new = Sketcher(p, chunk_positions=2048, batch=len(genomes),
                   packed=True)
    new.be_cap = 8  # force the extract-cap retry ladder
    assert new.packed_mode
    r_ref = ref.collect_batch(ref.submit_batch(genomes))
    r_new = new.collect_batch(new.submit_batch(genomes))
    for a, b in zip(r_ref, r_new):
        assert a["n_hashes"] == b["n_hashes"]
        assert a["norm2"] == b["norm2"]
        np.testing.assert_array_equal(a["hv"], b["hv"])


@pytest.mark.slow
def test_packed_rest_plane_overflow_detected():
    """Regression: rest-plane extraction uses a smaller cap than plane 0;
    its overflow must trip the SHARED be_max check (scaled into be_cap
    units), not silently drop hashes. scaled=30 at C=4096 makes the rest
    planes dense enough to overflow the initial rest cap (once caught on a
    device as a 14-hash loss in test_chunk_boundary_invariance)."""
    from hypergen_tpu.io.fastx import seq_to_codes
    from hypergen_tpu.models.sketcher import Sketcher
    from hypergen_tpu.params import SketchParams

    r = np.random.default_rng(5)
    seq = bytes(r.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=3000))
    codes = seq_to_codes(seq)
    p = SketchParams(scaled=30, hv_d=1024)
    ref = Sketcher(p, chunk_positions=128, packed=False).sketch_codes(
        codes
    )
    got = Sketcher(p, chunk_positions=4096, packed=True).sketch_codes(codes)
    assert got["n_hashes"] == ref["n_hashes"]
    np.testing.assert_array_equal(got["hv"], ref["hv"])


@pytest.mark.parametrize("scaled,C,L", [
    # the three densest configs are interpret-mode minutes each: slow lane
    # (HG_TEST_SLOW / -m slow)
    pytest.param(5, 2048, 1200, marks=pytest.mark.slow),
    # ^ extreme density: every capacity knob overflows
    pytest.param(30, 4096, 9000, marks=pytest.mark.slow),
    # ^ the rest-plane regression regime, multi-chunk
    (300, 2048, 2047),    # genome one short of a bucket boundary
    (1500, 4096, 500),    # production sparsity, tiny genome
    pytest.param(2, 2048, 8300, marks=pytest.mark.slow),
    # ^ 512-slot rest blocks at density ~1: needs rest_cap -> 512
    # (be_cap -> 2048), the regime the old be_cap<=512 ladder ceiling
    # could never satisfy (RuntimeError instead of parity)
])
def test_packed_capacity_stress_parity(scaled, C, L):
    """Capacity-stress sweep: densities and lengths chosen to overflow the
    cell-slot, plane-0, rest-plane, and extract caps in different
    combinations — every config must retry to bit-exactness, never drop.
    (The rest-plane overflow bug survived the default-parameter tests;
    this sweep exists so capacity bugs can't hide behind defaults.)"""
    from hypergen_tpu.io.fastx import INVALID
    from hypergen_tpu.models.sketcher import Sketcher
    from hypergen_tpu.params import SketchParams

    r = np.random.default_rng(scaled * 7 + C)
    codes = r.integers(0, 4, size=L).astype(np.uint8)
    for _ in range(4):
        s = int(r.integers(0, max(L - 60, 1)))
        codes[s : s + int(r.integers(1, 50))] = INVALID
    p = SketchParams(scaled=scaled, hv_d=512)
    ref = Sketcher(p, chunk_positions=128, packed=False).sketch_codes(
        codes
    )
    got = Sketcher(p, chunk_positions=C, packed=True).sketch_codes(codes)
    assert got["n_hashes"] == ref["n_hashes"]
    assert got["norm2"] == ref["norm2"]
    np.testing.assert_array_equal(got["hv"], ref["hv"])


@pytest.mark.parametrize("cells", [256, 512, 4096])
def test_kernel_parity_wide_cells(cells):
    """More cells per chunk (several programs per chunk, lsub = 16) must
    be bit-identical to the XLA path."""
    k = 21
    codes = rng.integers(0, 5, size=(2, 16 * cells + k - 1)).astype(np.uint8)
    _check(codes, k, 123, fracminhash_threshold(3), cells=cells)


def test_packed_cells_preference_and_cap_scaling():
    """packed_cells prefers lsub=64 with legal fallbacks, and the
    Sketcher's per-cell/extract caps scale with the chosen lsub."""
    from hypergen_tpu.models.sketcher import (
        Sketcher, packed_be_cap_default, packed_cells,
    )
    from hypergen_tpu.params import SketchParams

    assert packed_cells(1 << 17) == 2048          # production C, lsub 64
    assert packed_cells(1 << 13) == 128           # lsub 64, one block
    assert packed_cells(1 << 12) == 128           # lsub 32
    assert packed_cells(2048) == 128              # smallest packed bucket
    assert packed_cells(1024) == 0                # under one block of cells
    assert packed_cells(1000) == 0                # misaligned -> no packed
    be = packed_be_cap_default(1 << 17, 1500)
    assert 8 <= be <= 128
    sk = Sketcher(SketchParams(), batch=2, packed=True)
    assert sk.packed_mode
    lsub = sk.C // packed_cells(sk.C)
    assert sk.cell_cap >= 4 and sk.cell_cap <= lsub


@pytest.mark.gpu
@pytest.mark.parametrize("method,canonical", [
    ("t1ha2", True), ("mmhash", True), ("t1ha2", False),
])
def test_compiled_kernel_parity_on_gpu(method, canonical):
    """The kernel as Triton compiles it for the card == the XLA path
    (scaled=100: ~0.6 survivors per 64-position cell, 8 slots)."""
    codes = rng.integers(0, 5, size=(4, (1 << 17) + 20)).astype(np.uint8)
    _check(codes, 21, 123, fracminhash_threshold(100), method=method,
           canonical=canonical, interpret=False, cap=8)
