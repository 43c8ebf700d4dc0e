"""Invalid-run-list validity encoding: host extraction + device mask parity.

The runs variant ships (2-bit codes + [R, 2] invalid-run list) instead of a
dense validity bitmask (8x less H2D for the validity side); these tests pin
host run extraction, the device cumsum mask reconstruction, and end-to-end
equality of the two step variants.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from hypergen_tpu.io.fastx import INVALID
from hypergen_tpu.models.sketcher import (
    Sketcher,
    _valid_from_runs,
    find_invalid_runs,
    make_sketch_step,
    pack_codes,
    pack_codes_runs,
    split_step_output,
)
from hypergen_tpu.params import SketchParams, fracminhash_threshold


def _random_codes(rng, L, p_invalid=0.02, run_len=30):
    codes = rng.integers(0, 4, size=L, dtype=np.uint8)
    i = 0
    while i < L:
        if rng.random() < p_invalid:
            codes[i : i + rng.integers(1, run_len)] = INVALID
            i += run_len
        i += rng.integers(1, 200)
    return codes


class TestFindInvalidRuns:
    def test_empty_and_full(self):
        assert find_invalid_runs(np.zeros(8, np.uint8), 8, 8).shape == (0, 2)
        runs = find_invalid_runs(np.full(8, INVALID), 8, 8)
        np.testing.assert_array_equal(runs, [[0, 8]])

    def test_tail_padding_merge(self):
        codes = np.array([0, 1, INVALID, INVALID], np.uint8)
        runs = find_invalid_runs(codes, 4, 16)
        np.testing.assert_array_equal(runs, [[2, 16]])

    def test_tail_padding_separate(self):
        codes = np.array([INVALID, 1, 2, 3], np.uint8)
        runs = find_invalid_runs(codes, 4, 16)
        np.testing.assert_array_equal(runs, [[0, 1], [4, 16]])

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_roundtrip_random(self, seed):
        rng = np.random.default_rng(seed)
        L, P = 5000, 5120
        codes = _random_codes(rng, L)
        runs = find_invalid_runs(codes, L, P)
        valid = np.ones(P, bool)
        for s, e in runs:
            valid[s:e] = False
        exp = np.zeros(P, bool)
        exp[:L] = codes < INVALID
        np.testing.assert_array_equal(valid, exp)


class TestDeviceMask:
    def test_valid_from_runs_matches_host(self):
        rng = np.random.default_rng(3)
        L, P = 3000, 3072
        out = []
        for b in range(2):
            codes = _random_codes(rng, L)
            runs = find_invalid_runs(codes, L, P)
            padded = np.zeros((16, 2), np.int32)
            padded[: len(runs)] = runs
            out.append((codes, padded))
        runs_b = jnp.asarray(np.stack([r for _, r in out]))
        got = np.asarray(_valid_from_runs(runs_b, P))
        for b, (codes, _) in enumerate(out):
            exp = np.zeros(P, bool)
            exp[:L] = codes < INVALID
            np.testing.assert_array_equal(got[b], exp)

    def test_zero_padded_runs_are_noops(self):
        runs = jnp.zeros((1, 8, 2), jnp.int32)
        assert bool(np.all(_valid_from_runs(runs, 256)))


class TestStepVariantParity:
    def test_runs_equals_mask_step(self):
        p = SketchParams(scaled=30, hv_d=512)
        rng = np.random.default_rng(7)
        batch, n_chunks, C, k = 2, 2, 1024, p.ksize
        L_ext = n_chunks * C + k - 1
        L_pad = -(-L_ext // 8) * 8
        kw = dict(
            ksize=k, seed=p.seed, threshold=fracminhash_threshold(p.scaled),
            hv_d=p.hv_d, batch=batch, n_chunks=n_chunks, chunk_positions=C,
            chunk_cap=1024, enc_cap=1024, extract_block=0,
        )
        step_mask = make_sketch_step(validity="mask", **kw)
        step_runs = make_sketch_step(validity="runs", **kw)
        p2 = np.zeros((batch, L_pad // 4), np.uint8)
        pv = np.zeros((batch, L_pad // 8), np.uint8)
        runs = np.zeros((batch, 64, 2), np.int32)
        for i in range(batch):
            codes = _random_codes(rng, L_ext - 17)
            p2[i], pv[i] = pack_codes(codes, L_pad)
            p2b, runs[i], n_runs = pack_codes_runs(codes, L_pad, 64)
            assert n_runs <= 64
            np.testing.assert_array_equal(p2[i], p2b)
        hv_m, meta_m = split_step_output(
            np.asarray(step_mask(jnp.asarray(p2), jnp.asarray(pv)))
        )
        hv_r, meta_r = split_step_output(
            np.asarray(step_runs(jnp.asarray(p2), jnp.asarray(runs)))
        )
        np.testing.assert_array_equal(hv_m, hv_r)
        np.testing.assert_array_equal(meta_m, meta_r)

    def test_sketcher_run_cap_fallback(self, tmp_path):
        """A genome with more invalid runs than run_cap must still sketch
        exactly (dense-mask fallback)."""
        p = SketchParams(scaled=10, hv_d=256)
        rng = np.random.default_rng(9)
        codes = _random_codes(rng, 6000, p_invalid=0.5, run_len=3)
        sk_small = Sketcher(p, chunk_positions=1024, batch=1, run_cap=4)
        sk_big = Sketcher(p, chunk_positions=1024, batch=1, run_cap=4096)
        r1 = sk_small.sketch_codes(codes)
        r2 = sk_big.sketch_codes(codes)
        np.testing.assert_array_equal(r1["hv"], r2["hv"])
        assert r1["n_hashes"] == r2["n_hashes"]
