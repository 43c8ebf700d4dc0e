"""Single-device huge-genome tiling (r4 verdict item 4).

On one device a genome at/above seqpar_min_chunks must NOT compile a giant
one-shot bucket: Sketcher.sketch_packed_tiled streams fixed-shape tiles
through the probe="hashes" step, unions the per-tile survivor sets on the
host, and encodes the global set once. Dedup composes as set union and the
HV bundle as a sum, so the result must be BIT-IDENTICAL to the one-shot
step — these tests pin that, including tiles whose boundaries straddle
invalid runs, partial tail tiles, the packed (Pallas-interpret) input
format, and the sketch_files routing gate at device_count == 1.
"""

import numpy as np
import pytest

import hypergen_tpu.models.sketcher as sketcher_mod
from hypergen_tpu.io.fastx import INVALID, packed_from_codes
from hypergen_tpu.models.sketcher import Sketcher
from hypergen_tpu.params import SketchParams

HV_D = 256
SCALED = 40


def _genome(rng, bp, n_runs=3):
    codes = rng.integers(0, 4, size=bp).astype(np.uint8)
    for _ in range(n_runs):
        s = int(rng.integers(0, bp - 60))
        codes[s : s + int(rng.integers(3, 50))] = INVALID
    return codes


def _assert_same(a, b):
    assert np.array_equal(a["hv"], b["hv"])
    assert a["norm2"] == b["norm2"]
    assert a["n_hashes"] == b["n_hashes"]


@pytest.mark.parametrize("tile_chunks", [1, 3, 8])
def test_tiled_bit_equal_oneshot(tile_chunks):
    rng = np.random.default_rng(21)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genome(rng, 50_000)
    sk = Sketcher(p, chunk_positions=1024, batch=2)
    ref = sk.sketch_codes(codes)
    got = sk.sketch_packed_tiled(
        packed_from_codes(codes), tile_chunks=tile_chunks
    )
    _assert_same(ref, got)


def test_tiled_run_straddles_tile_boundary():
    # an invalid run crossing the tile edge must kill windows in BOTH
    # tiles (each tile carries the clipped run + the k-1 halo)
    rng = np.random.default_rng(22)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = rng.integers(0, 4, size=8192).astype(np.uint8)
    # tile_chunks=2 at C=1024 -> tile boundary at position 2048
    codes[2040:2060] = INVALID
    sk = Sketcher(p, chunk_positions=1024, batch=2)
    ref = sk.sketch_codes(codes)
    got = sk.sketch_packed_tiled(packed_from_codes(codes), tile_chunks=2)
    _assert_same(ref, got)


def test_tiled_duplicate_kmers_across_tiles():
    # the same k-mer in two tiles must encode ONCE (host set union) — a
    # repeated block guarantees cross-tile duplicate survivors
    rng = np.random.default_rng(23)
    p = SketchParams(hv_d=HV_D, scaled=4)  # dense survivors
    block = rng.integers(0, 4, size=1500).astype(np.uint8)
    codes = np.concatenate([block, rng.integers(0, 4, size=800), block, block])
    sk = Sketcher(p, chunk_positions=1024, batch=2)
    ref = sk.sketch_codes(codes)
    got = sk.sketch_packed_tiled(packed_from_codes(codes), tile_chunks=1)
    _assert_same(ref, got)


def test_tiled_packed_input_format_interpret():
    # the GPU production input format: fused packed Pallas step (interpret
    # mode) through the probe="hashes" branch
    rng = np.random.default_rng(24)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genome(rng, 20_000, n_runs=2)
    ref = Sketcher(
        p, chunk_positions=2048, batch=2, packed=False
    ).sketch_codes(codes)
    sk = Sketcher(
        p, chunk_positions=2048, batch=2, packed=True,
    )
    assert sk.packed_mode
    got = sk.sketch_packed_tiled(packed_from_codes(codes), tile_chunks=2)
    _assert_same(ref, got)


def test_sketch_files_routes_tiled_on_one_device(tmp_path, monkeypatch):
    rng = np.random.default_rng(25)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genome(rng, 30_000)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    seq = b2a[np.where(codes < 4, codes, 0)]
    seq[codes >= 4] = ord("N")
    f = tmp_path / "huge.fna"
    f.write_bytes(b">g\n" + seq.tobytes() + b"\n")

    ref = Sketcher(p, chunk_positions=1024, batch=2).sketch_codes(codes)

    monkeypatch.setattr(sketcher_mod.jax, "device_count", lambda: 1)
    called = []
    sk = Sketcher(
        p, chunk_positions=1024, batch=2, seqpar_min_chunks=8,
    )
    orig = sk.sketch_packed_tiled
    monkeypatch.setattr(
        sk, "sketch_packed_tiled",
        lambda g, **kw: called.append(kw) or orig(g, **kw),
    )
    out = sk.sketch_files([f], progress=False)
    assert called, "bucket >= seqpar_min_chunks must take the tiled path"
    assert np.array_equal(
        np.asarray(out[0].decompress(), np.int16), ref["hv"]
    )
    assert out[0].hv_norm_2 == ref["norm2"]


@pytest.mark.slow
def test_tiled_large_genome_bounded_memory():
    # ~16.8 Mbp on one (virtual) device: 16 tiles of 1 Mbp each; the
    # one-shot comparison uses the multi-device seqpar path, which is
    # independently pinned bit-equal to the single-shot step in
    # tests/test_parallel.py
    from hypergen_tpu.parallel.seqpar import sketch_codes_seqpar

    rng = np.random.default_rng(26)
    p = SketchParams(hv_d=HV_D, scaled=1500)
    codes = _genome(rng, 16_800_000, n_runs=12)
    C = 1 << 14
    got = Sketcher(p, chunk_positions=C, batch=4).sketch_packed_tiled(
        packed_from_codes(codes), tile_chunks=64
    )
    ref = sketch_codes_seqpar(codes, p, chunk_positions=C)
    _assert_same(ref, got)
