"""Exact-bucket-length parity grid (r2 verdict bug class).

A genome whose length exactly equals the padded bucket length (reachable
when (ksize-1) % 8 == 0) and which contains no N runs has an EMPTY
adjusted invalid-run list.  The r2 runs-path pre-seeded every row's run
list with a full-coverage padding marker and relied on real genomes to
overwrite it -- an empty run list wrote nothing, leaving the genome
silently marked fully invalid (n_hashes=0, wrong HV, no error).

This grid pins every validity path (runs / mask / packed-Pallas) against
the scalar oracle over k x {exact-bucket, off-by-one} x {with/without N
runs}, the corner the default-parameter grids missed.  Reference
behavior being matched: nothing silently drops k-mers
(reference:src/sketch.rs:71-98).
"""

import numpy as np
import pytest

from hypergen_tpu.models.sketcher import Sketcher
from hypergen_tpu.oracle.pipeline import sketch_genome
from hypergen_tpu.params import SketchParams

C = 2048  # smallest chunk_positions the packed path accepts (cells=128)
SCALED = 30
HV_D = 256
_B2A = np.frombuffer(b"ACGT", np.uint8)


def _codes_to_seq(codes: np.ndarray) -> bytes:
    out = _B2A[np.minimum(codes, 3)].copy()
    out[codes >= 4] = ord("N")
    return out.tobytes()


def _lengths(k: int):
    """Exact-bucket and off-by-one lengths for the 1-chunk bucket."""
    L_ext = C + k - 1
    L_pad = -(-L_ext // 8) * 8
    return sorted({L_pad, L_pad - 1, L_ext, L_ext - 1})


def _make_sketcher(path: str, p: SketchParams) -> Sketcher:
    if path == "runs":
        return Sketcher(p, chunk_positions=C, batch=1, packed=False)
    if path == "mask":
        # run_cap=-1 rejects even an empty run list -> dense-mask fallback
        return Sketcher(
            p, chunk_positions=C, batch=1, packed=False, run_cap=-1
        )
    assert path == "packed"
    return Sketcher(
        p, chunk_positions=C, batch=1, packed=True,
    )


@pytest.mark.parametrize("path", ["runs", "mask", "packed"])
@pytest.mark.parametrize("with_n", [False, True], ids=["pure", "nruns"])
@pytest.mark.parametrize("k", [17, 21, 25])
def test_bucket_length_corners(path, k, with_n):
    p = SketchParams(ksize=k, scaled=SCALED, hv_d=HV_D)
    sk = _make_sketcher(path, p)
    rng = np.random.default_rng(k * 7 + with_n)
    for L in _lengths(k):
        codes = rng.integers(0, 4, size=L, dtype=np.uint8)
        if with_n:
            codes[L // 3 : L // 3 + 5] = 4  # mid-genome N run
            codes[L - 3 :] = 4  # N run ending exactly at genome end
        res = sk.sketch_codes(codes)
        o = sketch_genome([_codes_to_seq(codes)], ksize=k, scaled=SCALED,
                          hv_d=HV_D)
        assert res["n_hashes"] == len(o["hashes"]), (
            f"path={path} k={k} L={L} with_n={with_n}: "
            f"{res['n_hashes']} != {len(o['hashes'])}"
        )
        np.testing.assert_array_equal(res["hv"], o["hv"])


@pytest.mark.parametrize("path", ["runs", "packed"])
def test_partial_batch_with_exact_length_row(path):
    """batch=2, one exact-bucket genome + one short genome: both rows must
    match the oracle and the unused padding row must not leak into them."""
    k = 17
    p = SketchParams(ksize=k, scaled=SCALED, hv_d=HV_D)
    if path == "runs":
        sk = Sketcher(p, chunk_positions=C, batch=3, packed=False)
    else:
        sk = Sketcher(p, chunk_positions=C, batch=3, packed=True)
    L_pad = -(-(C + k - 1) // 8) * 8
    rng = np.random.default_rng(11)
    g1 = rng.integers(0, 4, size=L_pad, dtype=np.uint8)  # empty run list
    g2 = rng.integers(0, 4, size=L_pad - 123, dtype=np.uint8)
    handle = sk.submit_batch([g1, g2])
    results = sk.collect_batch(handle)
    assert len(results) == 2
    for codes, res in zip([g1, g2], results):
        o = sketch_genome([_codes_to_seq(codes)], ksize=k, scaled=SCALED,
                          hv_d=HV_D)
        assert res["n_hashes"] == len(o["hashes"])
        np.testing.assert_array_equal(res["hv"], o["hv"])
