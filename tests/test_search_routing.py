"""Search-mode routing: production-scale HVs must take the 3-matmul
"small" Karatsuba split (r4 verdict item 3).

`_resolve_split` upgrades int8_split=True to "small" when every |hv| fits
SMALL_SPLIT_MAX (all genomes <~9 Mbp at scaled=1500 — the production
regime), cutting the exact int16 dot from 4 int8 matmuls to 3. These
tests pin (a) the resolver's decision boundary, (b) that `run_search_cli`
actually routes through it when the capability table picks int8 dots
(the GPU), and (c) that the
"small" TSV is byte-identical to the plain-path TSV (the split is exact
mod 2^32, so routing can never change output).
"""

import numpy as np
import pytest

import hypergen_tpu.parallel.search as search_mod
from hypergen_tpu.cli import main as cli_main
from hypergen_tpu.ops.ani import SMALL_SPLIT_MAX, dot_i16_exact
from hypergen_tpu.parallel.search import _resolve_split


def _write_genome(path, length, seed):
    rng = np.random.default_rng(seed)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=length)
    path.write_bytes(b">g\n" + seq.tobytes() + b"\n")


class TestResolveMxu:
    def test_production_scale_upgrades_to_small(self):
        rng = np.random.default_rng(0)
        db = rng.integers(-200, 200, size=(16, 64)).astype(np.int16)
        q = rng.integers(-200, 200, size=(4, 64)).astype(np.int16)
        assert _resolve_split(True, db, q) == "small"

    def test_boundary_value_still_small(self):
        a = np.full((2, 8), SMALL_SPLIT_MAX, dtype=np.int16)
        assert _resolve_split(True, a, -a) == "small"

    def test_over_bound_falls_back_to_four_pass(self):
        a = np.full((2, 8), SMALL_SPLIT_MAX + 1, dtype=np.int16)
        assert _resolve_split(True, a, a) is True

    def test_explicit_false_untouched(self):
        a = np.zeros((2, 8), dtype=np.int16)
        assert _resolve_split(False, a, a) is False

    def test_small_split_exact_at_boundary(self):
        rng = np.random.default_rng(1)
        r = rng.integers(
            -SMALL_SPLIT_MAX, SMALL_SPLIT_MAX + 1, size=(8, 128)
        ).astype(np.int16)
        q = rng.integers(
            -SMALL_SPLIT_MAX, SMALL_SPLIT_MAX + 1, size=(8, 128)
        ).astype(np.int16)
        # include the extreme corners
        r[0, :] = SMALL_SPLIT_MAX
        q[0, :] = SMALL_SPLIT_MAX
        r[1, :] = -SMALL_SPLIT_MAX
        got = np.asarray(dot_i16_exact(r, q, int8_split="small"))
        exp = np.asarray(dot_i16_exact(r, q, int8_split=False))
        np.testing.assert_array_equal(got, exp)


class TestSmallPresplit:
    """Resident-DB SmallSplit planes (h, l, h+l): one int8 matmul fewer per
    query and no per-query r-side split — must stay exact, including the
    rebuild fallback when an over-bound query batch meets a small-resident
    DB (r5)."""

    def _rand(self, rng, m, bound):
        return rng.integers(-bound, bound + 1, size=(m, 128)).astype(np.int16)

    def test_presplit_small_exact(self):
        from hypergen_tpu.ops.ani import dot_i16_any, presplit_rows_small

        rng = np.random.default_rng(3)
        r = self._rand(rng, 16, SMALL_SPLIT_MAX)
        q = self._rand(rng, 8, SMALL_SPLIT_MAX)
        r[0, :] = SMALL_SPLIT_MAX
        q[0, :] = -SMALL_SPLIT_MAX
        got = np.asarray(
            dot_i16_any(presplit_rows_small(r), q, int8_split="small")
        )
        exp = np.asarray(dot_i16_exact(r, q, int8_split=False))
        np.testing.assert_array_equal(got, exp)

    def test_smallsplit_fallback_rebuilds_exact_rows(self):
        # big-valued queries against a SmallSplit-resident DB: dot_i16_any
        # must rebuild exact int16 rows and take the 4-way path
        from hypergen_tpu.ops.ani import dot_i16_any, presplit_rows_small

        rng = np.random.default_rng(4)
        r = self._rand(rng, 16, SMALL_SPLIT_MAX)
        q = self._rand(rng, 8, 32000)  # way over SMALL_SPLIT_MAX
        got = np.asarray(dot_i16_any(presplit_rows_small(r), q, int8_split=True))
        exp = np.asarray(dot_i16_exact(r, q, int8_split=False))
        np.testing.assert_array_equal(got, exp)

    def test_comparator_preload_routes_small(self):
        from hypergen_tpu.models.comparator import Comparator
        from hypergen_tpu.ops.ani import SmallSplit

        rng = np.random.default_rng(5)
        r = self._rand(rng, 24, 500)
        q = self._rand(rng, 10, 500)
        comp = Comparator(ksize=21, tile_m=16, tile_n=8, int8_split=True)
        blocks = comp.preload_rows(r)
        assert all(isinstance(b, SmallSplit) for b in blocks)
        got = {}
        for mi, nj, tile in comp.dot_tiles(r, q, r_blocks=blocks):
            got[(mi, nj)] = tile
        plain = Comparator(ksize=21, tile_m=16, tile_n=8, int8_split=False)
        for mi, nj, tile in plain.dot_tiles(r, q):
            np.testing.assert_array_equal(got[(mi, nj)], tile)

    def test_comparator_preload_big_values_stay_four_way(self):
        from hypergen_tpu.models.comparator import Comparator
        from hypergen_tpu.ops.ani import SmallSplit

        rng = np.random.default_rng(6)
        r = self._rand(rng, 8, 30000)
        comp = Comparator(ksize=21, tile_m=8, tile_n=8, int8_split=True)
        blocks = comp.preload_rows(r)
        assert not any(isinstance(b, SmallSplit) for b in blocks)

    def test_preload_ref_thresholded_small(self):
        # the dist -a path with a small-resident ref must stay row-exact
        from hypergen_tpu.io.sketch_db import ShardedDB
        from hypergen_tpu.models.comparator import Comparator
        from hypergen_tpu.ops.ani import SmallSplit

        rng = np.random.default_rng(7)
        D = 128
        hv = rng.integers(-60, 60, size=(20, D)).astype(np.int16)
        norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)

        def db(h, n):
            return ShardedDB(
                ksize=21, scaled=1500, canonical=True, seed=1, hv_d=D,
                names=[f"g{i}" for i in range(h.shape[0])], hvs=h, norms=n,
            )

        comp = Comparator(ksize=21, tile_m=8, tile_n=8, int8_split=True)
        blocks = comp.preload_ref(db(hv, norms))
        assert all(isinstance(b[0], SmallSplit) for b in blocks)
        got = comp.ani_pairs_thresholded(
            db(hv, norms), db(hv, norms), symmetric=True, threshold=0.0,
            ref_blocks=blocks,
        )
        exp = Comparator(
            ksize=21, tile_m=8, tile_n=8, int8_split=False
        ).ani_pairs_thresholded(
            db(hv, norms), db(hv, norms), symmetric=True, threshold=0.0,
        )
        for a, b in zip(got, exp):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestCliRouting:
    def _sketch(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        for i in range(4):
            _write_genome(data / f"g{i}.fna", 4000, seed=50 + i)
        out = tmp_path / "db.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "30", "-d", "1024"])
        return out

    def test_run_search_cli_routes_small(self, tmp_path, monkeypatch):
        db = self._sketch(tmp_path)
        # baseline TSV on the CPU-default (int32 dot) path
        base_tsv = tmp_path / "base.tsv"
        cli_main(["search", "-r", str(db), "-q", str(db),
                  "-o", str(base_tsv), "-a", "0.0", "--top_k", "2"])

        # pretend the capability table chose the GPU's int8 dots and
        # record what the resolver decided for the e2e search path
        from hypergen_tpu.backend import Caps

        monkeypatch.setattr(search_mod, "caps", lambda: Caps(
            hash_path="packed", dot_mode=True, interpret=False))
        decided = []
        orig = search_mod._resolve_split.__wrapped__ if hasattr(
            search_mod._resolve_split, "__wrapped__") else search_mod._resolve_split

        def spy(mode, *arrays):
            out = orig(mode, *arrays)
            decided.append(out)
            return out

        monkeypatch.setattr(search_mod, "_resolve_split", spy)
        small_tsv = tmp_path / "small.tsv"
        cli_main(["search", "-r", str(db), "-q", str(db),
                  "-o", str(small_tsv), "-a", "0.0", "--top_k", "2"])
        assert decided == ["small"], (
            "production-scale search must route to the 3-matmul split"
        )
        # exact mod-2^32 split + host ANI recompute: bytes must not move
        assert small_tsv.read_bytes() == base_tsv.read_bytes()
