"""Fused D2H collect (collect_batches) bit-parity with per-batch collect.

Every device_get is a separate transfer, so sketch_files fuses up to collect_group in-flight step outputs into one
device-side concat + single fetch (models/sketcher.py collect_batches).
The fusion must be a pure transport optimization: results byte-identical
to one-at-a-time collection for every group size, including the
repeat-padded partial group and the single-handle fast path, and the
capacity-retry ladder must still fire on the per-batch slices.
"""

import numpy as np
import pytest

from hypergen_tpu.models.sketcher import Sketcher
from hypergen_tpu.params import SketchParams

HV_D = 256
SCALED = 40


def _genomes(n, rng, bp=6000):
    return [rng.integers(0, 4, size=bp).astype(np.uint8) for i in range(n)]


def _collect_single(sk, codes):
    return [sk.sketch_codes(c) for c in codes]


def _assert_same(a, b):
    assert np.array_equal(a["hv"], b["hv"])
    assert a["norm2"] == b["norm2"]
    assert a["n_hashes"] == b["n_hashes"]


@pytest.mark.parametrize("group", [1, 2, 4])
def test_collect_batches_matches_individual(group):
    rng = np.random.default_rng(7)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genomes(6, rng)
    ref = _collect_single(
        Sketcher(p, chunk_positions=1024, batch=2), codes
    )
    sk = Sketcher(p, chunk_positions=1024, batch=2, collect_group=group)
    handles = [sk.submit_batch(codes[i : i + 2]) for i in range(0, 6, 2)]
    got = [r for batch in sk.collect_batches(handles) for r in batch]
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        _assert_same(a, b)


def test_collect_batches_partial_group_padded():
    # 3 handles with collect_group=4 exercises the repeat-padding branch
    rng = np.random.default_rng(8)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genomes(3, rng, bp=3000)
    ref = _collect_single(
        Sketcher(p, chunk_positions=1024, batch=1), codes
    )
    sk = Sketcher(p, chunk_positions=1024, batch=1, collect_group=4)
    handles = [sk.submit_batch([c]) for c in codes]
    got = [r for batch in sk.collect_batches(handles) for r in batch]
    for a, b in zip(ref, got):
        _assert_same(a, b)


def test_sketch_files_group_drain_order(tmp_path):
    # 7 files, batch=1, depth+group drain: output order must match input
    # order and every sketch must match the individually-collected result
    rng = np.random.default_rng(9)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genomes(7, rng, bp=2500)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for i, c in enumerate(codes):
        f = tmp_path / f"g{i}.fna"
        f.write_bytes(b">g\n" + b2a[c].tobytes() + b"\n")
        paths.append(f)
    ref = _collect_single(
        Sketcher(p, chunk_positions=1024, batch=1), codes
    )
    sk = Sketcher(p, chunk_positions=1024, batch=1, collect_group=3)
    out = sk.sketch_files(paths, progress=False, pipeline_depth=2)
    assert len(out) == 7
    assert sk.last_h2d_bytes > 0
    for fs, r in zip(out, ref):
        assert np.array_equal(
            np.asarray(fs.decompress(), np.int16), r["hv"]
        )
        assert fs.hv_norm_2 == r["norm2"]


def test_collect_batches_packed_path_interpret():
    # the GPU production path: fused packed Pallas step under the fused
    # collect (interpret mode runs the same kernel logic on CPU)
    rng = np.random.default_rng(12)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genomes(4, rng, bp=4500)
    ref = _collect_single(
        Sketcher(p, chunk_positions=2048, batch=2, packed=False), codes
    )
    sk = Sketcher(
        p, chunk_positions=2048, batch=2, packed=True, collect_group=2,
    )
    assert sk.packed_mode  # make sure this really is the packed path
    handles = [sk.submit_batch(codes[i : i + 2]) for i in range(0, 4, 2)]
    got = [r for batch in sk.collect_batches(handles) for r in batch]
    for a, b in zip(ref, got):
        _assert_same(a, b)


@pytest.mark.parametrize("threads", [0, 1])
def test_sketch_files_uploader_thread_parity(tmp_path, threads):
    # the dedicated background uploader (r5) must be a pure scheduling
    # change: byte-identical sketches and input-order output vs the
    # synchronous dispatch path, including partial batches and the
    # window-bound drain interleaving
    rng = np.random.default_rng(11)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genomes(9, rng, bp=2800)
    b2a = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for i, c in enumerate(codes):
        f = tmp_path / f"u{i}.fna"
        f.write_bytes(b">g\n" + b2a[c].tobytes() + b"\n")
        paths.append(f)
    ref = _collect_single(
        Sketcher(p, chunk_positions=1024, batch=2), codes
    )
    sk = Sketcher(
        p, chunk_positions=1024, batch=2, collect_group=2,
        upload_threads=threads,
    )
    out = sk.sketch_files(paths, progress=False, pipeline_depth=2)
    assert len(out) == 9
    assert sk.last_h2d_bytes > 0  # accounting moved to drain; must survive
    assert "upload_wait" in sk.last_stage_times
    for fs, r in zip(out, ref):
        assert np.array_equal(
            np.asarray(fs.decompress(), np.int16), r["hv"]
        )
        assert fs.hv_norm_2 == r["norm2"]


def test_partial_batch_dispatches_pow2_rows():
    # a 3-genome flush at batch=16 must ship a 4-row buffer, not 16:
    # padding rows are real upload bytes and device work
    rng = np.random.default_rng(13)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genomes(3, rng, bp=2600)
    ref = _collect_single(Sketcher(p, chunk_positions=1024, batch=1), codes)
    sk = Sketcher(p, chunk_positions=1024, batch=16)
    h = sk.submit_batch(codes)
    assert h["rows"] == 4
    full_rows_bytes = h["h2d_bytes"] * 4  # rows scale the payload linearly
    sk_small = Sketcher(p, chunk_positions=1024, batch=4)
    assert sk_small.submit_batch(codes)["h2d_bytes"] == h["h2d_bytes"]
    assert full_rows_bytes > h["h2d_bytes"]
    got = sk.collect_batch(h)
    for a, b in zip(ref, got):
        _assert_same(a, b)


def test_collect_batches_mixed_row_counts():
    # fused collect over handles with DIFFERENT device row counts (a full
    # batch + a pow2 partial): the concat split must use per-handle offsets
    rng = np.random.default_rng(14)
    p = SketchParams(hv_d=HV_D, scaled=SCALED)
    codes = _genomes(3, rng, bp=2200)
    ref = _collect_single(Sketcher(p, chunk_positions=1024, batch=1), codes)
    sk = Sketcher(p, chunk_positions=1024, batch=2, collect_group=2)
    h_full = sk.submit_batch(codes[:2])   # rows = 2
    h_part = sk.submit_batch(codes[2:])   # rows = 1
    assert h_full["rows"] == 2 and h_part["rows"] == 1
    got = [r for batch in sk.collect_batches([h_full, h_part]) for r in batch]
    for a, b in zip(ref, got):
        _assert_same(a, b)


def test_collect_batches_retry_on_fused_slice():
    # force an encode-cap overflow inside a fused group: a repeat-heavy
    # genome (all-A) occupies one batch; the retry must recompute ONLY
    # from that batch's handle and still return exact results
    rng = np.random.default_rng(10)
    p = SketchParams(hv_d=HV_D, scaled=2)  # scaled=2 keeps ~half of hashes
    normal = rng.integers(0, 4, size=4000).astype(np.uint8)
    repeat = np.zeros(4000, dtype=np.uint8)  # poly-A: huge occurrence count
    ref = _collect_single(
        Sketcher(p, chunk_positions=1024, batch=1), [normal, repeat]
    )
    sk = Sketcher(p, chunk_positions=1024, batch=1, collect_group=2)
    handles = [sk.submit_batch([normal]), sk.submit_batch([repeat])]
    got = [r for batch in sk.collect_batches(handles) for r in batch]
    for a, b in zip(ref, got):
        _assert_same(a, b)
