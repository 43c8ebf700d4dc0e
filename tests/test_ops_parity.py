"""Device-op parity vs. the pure-Python oracle (runs on the CPU backend)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hypergen_tpu.ops import u64 as u
from hypergen_tpu.ops.u64 import U64
from hypergen_tpu.ops import hashes as oph
from hypergen_tpu.ops.kmers import canonical_kmer_words, hash_kmer_positions
from hypergen_tpu.ops.compact import compact_masked
from hypergen_tpu.ops.encode import encode_hv, hv_to_i16, hv_norm2_i32
from hypergen_tpu.ops.ani import ani_from_dot_matrix, dot_i16_exact
from hypergen_tpu.oracle import hashes as orh
from hypergen_tpu.oracle import pipeline as orp
from hypergen_tpu.io.fastx import seq_to_codes
from hypergen_tpu.params import fracminhash_threshold

M64 = (1 << 64) - 1
rng = np.random.default_rng(42)


def rand_u64(n):
    return rng.integers(0, 1 << 64, size=n, dtype=np.uint64)


def as_pairs(arr_u64):
    return u.from_np_u64(arr_u64)


class TestU64:
    def test_roundtrip(self):
        x = rand_u64(100)
        np.testing.assert_array_equal(u.to_np_u64(as_pairs(x)), x)

    def test_add(self):
        a, b = rand_u64(200), rand_u64(200)
        got = u.to_np_u64(u.add(as_pairs(a), as_pairs(b)))
        exp = (a.astype(object) + b.astype(object)) % (1 << 64)
        np.testing.assert_array_equal(got.astype(object), exp)

    def test_mul128(self):
        a, b = rand_u64(200), rand_u64(200)
        hi, lo = u.mul128(as_pairs(a), as_pairs(b))
        full = a.astype(object) * b.astype(object)
        np.testing.assert_array_equal(u.to_np_u64(lo).astype(object), full % (1 << 64))
        np.testing.assert_array_equal(u.to_np_u64(hi).astype(object), full >> 64)

    def test_mul_lo(self):
        a, b = rand_u64(200), rand_u64(200)
        got = u.to_np_u64(u.mul_lo(as_pairs(a), as_pairs(b)))
        exp = (a.astype(object) * b.astype(object)) % (1 << 64)
        np.testing.assert_array_equal(got.astype(object), exp)

    @pytest.mark.parametrize("s", [1, 7, 23, 31, 32, 33, 41, 63])
    def test_shifts_rot(self, s):
        a = rand_u64(64)
        pa = as_pairs(a)
        np.testing.assert_array_equal(
            u.to_np_u64(u.shl(pa, s)).astype(object),
            (a.astype(object) << s) % (1 << 64),
        )
        np.testing.assert_array_equal(
            u.to_np_u64(u.shr(pa, s)).astype(object), a.astype(object) >> s
        )
        exp_rot = ((a.astype(object) >> s) | (a.astype(object) << (64 - s))) % (1 << 64)
        np.testing.assert_array_equal(
            u.to_np_u64(u.rot_right(pa, s)).astype(object), exp_rot
        )

    def test_lt(self):
        a, b = rand_u64(500), rand_u64(500)
        a[:50] = b[:50]  # exercise equal-hi paths
        got = np.asarray(u.lt(as_pairs(a), as_pairs(b)))
        np.testing.assert_array_equal(got, a < b)

    def test_lt_const_threshold(self):
        thr = fracminhash_threshold(1500)
        a = rand_u64(500)
        a[:10] = thr  # boundary: strict less-than
        got = np.asarray(u.lt_const(as_pairs(a), thr))
        np.testing.assert_array_equal(got, a < np.uint64(thr))


class TestHashes:
    @pytest.mark.parametrize("length", [1, 5, 8, 9, 16, 17, 21, 24, 25, 31, 32])
    def test_t1ha2_vs_oracle(self, length):
        n = 32
        data = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
        seed = 123
        exp = np.array(
            [orh.t1ha2_atonce(bytes(row), seed) for row in data], dtype=np.uint64
        )
        words = _bytes_to_words(data, length)
        got = u.to_np_u64(oph.t1ha2_atonce_words(words, length, seed))
        np.testing.assert_array_equal(got, exp)

    def test_t1ha2_seed_variants(self):
        data = rng.integers(0, 256, size=(8, 21), dtype=np.uint8)
        for seed in [0, 123, M64, 42424242]:
            exp = np.array(
                [orh.t1ha2_atonce(bytes(r), seed) for r in data], dtype=np.uint64
            )
            got = u.to_np_u64(
                oph.t1ha2_atonce_words(_bytes_to_words(data, 21), 21, seed)
            )
            np.testing.assert_array_equal(got, exp)

    def test_mm_hash64_vs_oracle(self):
        keys = rand_u64(200)
        exp = np.array([orh.mm_hash64(int(k)) for k in keys], dtype=np.uint64)
        got = u.to_np_u64(oph.mm_hash64(as_pairs(keys)))
        np.testing.assert_array_equal(got, exp)

    def test_wyrng_words_vs_oracle(self):
        W = 16
        seeds = rand_u64(20)
        offsets = u.from_np_u64(oph.wyrng_word_offsets(W))
        w_hi, w_lo = oph.wyrng_words_from_hash(as_pairs(seeds), offsets)
        got = (np.asarray(w_hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(
            w_lo, dtype=np.uint64
        )
        for i, s in enumerate(seeds):
            exp = orh.wyrng_words(int(s), W)
            np.testing.assert_array_equal(got[i], np.array(exp, dtype=np.uint64))


def _bytes_to_words(data: np.ndarray, length: int):
    """Host-side packing of byte rows into LE u64 word U64s (test helper)."""
    n_words = (length + 7) // 8
    padded = np.zeros((data.shape[0], n_words * 8), dtype=np.uint8)
    padded[:, :length] = data[:, :length]
    w64 = padded.view("<u8")  # [n, n_words]
    return [as_pairs(np.ascontiguousarray(w64[:, i])) for i in range(n_words)]


class TestKmers:
    def _random_seq(self, n, with_junk=True):
        alphabet = b"ACGTacgt"
        seq = rng.choice(list(alphabet), size=n).astype(np.uint8)
        if with_junk:
            junk_pos = rng.choice(n, size=max(1, n // 20), replace=False)
            seq[junk_pos] = ord("N")
        return seq.tobytes()

    @pytest.mark.parametrize("k", [3, 15, 21, 31])
    def test_hash_positions_vs_oracle(self, k):
        seq = self._random_seq(400)
        codes = seq_to_codes(seq)
        h, keep = hash_kmer_positions(
            jnp.asarray(codes), k, seed=123, threshold=M64, canonical=True
        )
        got = u.to_np_u64(h)[np.asarray(keep)]
        norm = orp.normalize_seq(seq)
        exp = [orh.t1ha2_atonce(km, 123) for km in orp.canonical_kmers(norm, k)]
        np.testing.assert_array_equal(got, np.array(exp, dtype=np.uint64))

    def test_threshold_filtering(self):
        seq = self._random_seq(2000, with_junk=False)
        codes = seq_to_codes(seq)
        thr = fracminhash_threshold(4)
        h, keep = hash_kmer_positions(
            jnp.asarray(codes), 21, seed=123, threshold=thr, canonical=True
        )
        kept = u.to_np_u64(h)[np.asarray(keep)]
        exp = sorted(
            orp.extract_kmer_hashes([seq], ksize=21, scaled=4, seed=123)
        )
        assert sorted(set(kept.tolist())) == exp

    def test_noncanonical(self):
        seq = b"ACGTTGCAACGTTGCAACGTTGCA" * 4
        codes = seq_to_codes(seq)
        h, keep = hash_kmer_positions(
            jnp.asarray(codes), 21, seed=123, threshold=M64, canonical=False
        )
        norm = orp.normalize_seq(seq)
        exp = [
            orh.t1ha2_atonce(km, 123) for km in orp._forward_kmers(norm, 21)
        ]
        got = u.to_np_u64(h)[np.asarray(keep)]
        np.testing.assert_array_equal(got, np.array(exp, dtype=np.uint64))

    def test_mmhash_method(self):
        seq = self._random_seq(300, with_junk=False)
        codes = seq_to_codes(seq)
        h, keep = hash_kmer_positions(
            jnp.asarray(codes), 21, seed=123, threshold=M64,
            canonical=True, method="mmhash",
        )
        norm = orp.normalize_seq(seq)
        exp = [
            orh.mm_hash64(orp._pack_2bit(km))
            for km in orp.canonical_kmers(norm, 21)
        ]
        got = u.to_np_u64(h)[np.asarray(keep)]
        np.testing.assert_array_equal(got, np.array(exp, dtype=np.uint64))

    def test_batched_leading_dim(self):
        seqs = [self._random_seq(200) for _ in range(4)]
        codes = np.stack([seq_to_codes(s) for s in seqs])
        h, keep = hash_kmer_positions(
            jnp.asarray(codes), 21, seed=123, threshold=M64, canonical=True
        )
        assert h.lo.shape == (4, 200 - 20)
        for b, seq in enumerate(seqs):
            norm = orp.normalize_seq(seq)
            exp = [orh.t1ha2_atonce(km, 123) for km in orp.canonical_kmers(norm, 21)]
            got = u.to_np_u64(h[b])[np.asarray(keep[b])]
            np.testing.assert_array_equal(got, np.array(exp, dtype=np.uint64))


class TestCompact:
    def test_compact_flat(self):
        n, cap = 300, 64
        vals = rand_u64(n)
        keep = rng.random(n) < 0.1
        out, count = compact_masked(as_pairs(vals), jnp.asarray(keep), cap)
        assert int(count) == keep.sum()
        got = u.to_np_u64(out)[: int(count)]
        np.testing.assert_array_equal(got, vals[keep])

    def test_compact_batched(self):
        vals = rand_u64(4 * 100).reshape(4, 100)
        keep = rng.random((4, 100)) < 0.2
        out, count = compact_masked(as_pairs(vals), jnp.asarray(keep), 40)
        for b in range(4):
            c = int(count[b])
            assert c == keep[b].sum()
            np.testing.assert_array_equal(u.to_np_u64(out[b])[:c], vals[b][keep[b]])

    def test_overflow_reports_true_count(self):
        vals = rand_u64(50)
        keep = np.ones(50, dtype=bool)
        out, count = compact_masked(as_pairs(vals), jnp.asarray(keep), 10)
        assert int(count) == 50  # caller detects cap overflow


class TestEncode:
    @pytest.mark.parametrize("hv_d", [256, 1024])
    def test_encode_vs_oracle(self, hv_d):
        n = 37
        hashes = rand_u64(n)
        pad_to = 64
        h_pad = np.zeros(pad_to, dtype=np.uint64)
        h_pad[:n] = hashes
        valid = np.arange(pad_to) < n
        hv = encode_hv(
            as_pairs(h_pad[None, :]), jnp.asarray(valid[None, :]), hv_d, block=32
        )
        got = hv_to_i16(hv)[0]
        exp = orp.encode_hash_hd(hashes.tolist(), hv_d)
        np.testing.assert_array_equal(np.asarray(got), exp)

    def test_csa_matches_expand_path(self):
        """Pow2 blocks route through the carry-save-adder column counter;
        non-pow2 blocks keep the expand-and-sum path. Both must agree
        bit-exactly for any valid pattern (incl. all-invalid rows)."""
        B, n, hv_d = 3, 700, 4096
        h = as_pairs(rand_u64(B * n).reshape(B, n))
        valid = rng.random((B, n)) < 0.8
        valid[1, :] = False
        v = jnp.asarray(valid)
        ref = np.asarray(encode_hv(h, v, hv_d, block=100))  # expand path
        assert (ref[1] == 0).all()
        for blk in (64, 256, 512, 1024):
            got = np.asarray(encode_hv(h, v, hv_d, block=blk))  # CSA path
            np.testing.assert_array_equal(got, ref)
        # forced paths at the same pow2 block must agree too
        a = np.asarray(encode_hv(h, v, hv_d, block=256, csa=True))
        b = np.asarray(encode_hv(h, v, hv_d, block=256, csa=False))
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, ref)

    def test_norm2(self):
        hv = rng.integers(-300, 300, size=(2, 512)).astype(np.int16)
        got = np.asarray(hv_norm2_i32(jnp.asarray(hv)))
        exp = [orp.hv_norm2(hv[i]) for i in range(2)]
        np.testing.assert_array_equal(got, exp)


class TestAni:
    def test_dot_exact_both_paths(self):
        r = rng.integers(-3000, 3000, size=(5, 512)).astype(np.int16)
        q = rng.integers(-3000, 3000, size=(7, 512)).astype(np.int16)
        exp = r.astype(np.int64) @ q.astype(np.int64).T
        exp_wrapped = ((exp + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
        for int8_split in (False, True):
            got = np.asarray(dot_i16_exact(jnp.asarray(r), jnp.asarray(q), int8_split))
            np.testing.assert_array_equal(got, exp_wrapped)

    def test_dot_exact_extreme_values(self):
        """int8-split must survive the full i16 range incl. 32767/-32768."""
        r = np.array([[32767, -32768, 255, -256, 1] * 128], dtype=np.int16)
        q = np.array([[-32768, 32767, -1, 256, 0] * 128], dtype=np.int16)
        exp = int((r.astype(np.int64) @ q.astype(np.int64).T)[0, 0])
        exp = ((exp + (1 << 31)) % (1 << 32)) - (1 << 31)
        for int8_split in (False, True):
            got = int(dot_i16_exact(jnp.asarray(r), jnp.asarray(q), int8_split)[0, 0])
            assert got == exp

    def test_dot_small_split_exact(self):
        """3-matmul Karatsuba split == direct int32 dot over its full
        admissible range, including both boundary values."""
        from hypergen_tpu.ops.ani import SMALL_SPLIT_MAX

        V = SMALL_SPLIT_MAX
        r = rng.integers(-V, V + 1, size=(5, 512)).astype(np.int16)
        q = rng.integers(-V, V + 1, size=(7, 512)).astype(np.int16)
        r[0, :4] = [V, -V, V, -V]
        q[0, :4] = [V, -V, -V, V]
        exp = r.astype(np.int64) @ q.astype(np.int64).T
        exp = ((exp + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
        got = np.asarray(
            dot_i16_exact(jnp.asarray(r), jnp.asarray(q), int8_split="small")
        )
        np.testing.assert_array_equal(got, exp)

    def test_dot_presplit_exact(self):
        """Pre-split resident operand path == direct dot, full i16 range."""
        from hypergen_tpu.ops.ani import dot_i16_any, presplit_rows

        r = rng.integers(-32768, 32768, size=(5, 512)).astype(np.int16)
        q = rng.integers(-32768, 32768, size=(7, 512)).astype(np.int16)
        r[0, :2] = [32767, -32768]
        exp = r.astype(np.int64) @ q.astype(np.int64).T
        exp = ((exp + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)
        planes = presplit_rows(jnp.asarray(r))
        got = np.asarray(dot_i16_any(planes, jnp.asarray(q)))
        np.testing.assert_array_equal(got, exp)

    def test_dot_mode_gate(self):
        """Comparator picks the small split only when every value fits."""
        from hypergen_tpu.models.comparator import Comparator
        from hypergen_tpu.ops.ani import SMALL_SPLIT_MAX

        comp = Comparator(21, int8_split=True)
        ok = np.full((2, 256), SMALL_SPLIT_MAX, dtype=np.int16)
        too_big = ok.copy()
        too_big[1, 3] = SMALL_SPLIT_MAX + 1
        neg_edge = ok.copy()
        neg_edge[0, 0] = -32768  # np.abs wraps in int16; gate must not
        assert comp.dot_mode(ok, ok) == "small"
        assert comp.dot_mode(ok, too_big) is True
        assert comp.dot_mode(neg_edge, ok) is True
        comp_cpu = Comparator(21, int8_split=False)
        assert comp_cpu.dot_mode(ok, ok) is False

    def test_ani_matrix_vs_oracle(self):
        rng2 = np.random.default_rng(7)
        r = rng2.integers(-50, 50, size=(4, 1024)).astype(np.int16)
        q = np.concatenate([r[:2], rng2.integers(-50, 50, (3, 1024)).astype(np.int16)])
        nr = np.array([orp.hv_norm2(x) for x in r], dtype=np.int32)
        nq = np.array([orp.hv_norm2(x) for x in q], dtype=np.int32)
        dot = (r.astype(np.int64) @ q.astype(np.int64).T).astype(np.int32)
        got = np.asarray(
            ani_from_dot_matrix(jnp.asarray(dot), jnp.asarray(nr), jnp.asarray(nq), 21)
        )
        # device formula may differ from scalar f32 evaluation by O(1e-4)
        # (XLA algebraic rewrites); the TSV path uses the host map instead
        for i in range(4):
            for j in range(q.shape[0]):
                exp = orp.ani_from_dot(int(dot[i, j]), int(nr[i]), int(nq[j]), 21)
                assert got[i, j] == pytest.approx(exp, abs=2e-3)
        # identical sketches -> 100
        assert got[0, 0] == pytest.approx(100.0)
        assert got[1, 1] == pytest.approx(100.0)


class TestThresholdedDist:
    def _db(self, rng, n, d=256):
        from hypergen_tpu.io.sketch_db import ShardedDB

        hv = rng.integers(-30, 30, size=(n, d)).astype(np.int16)
        norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)
        return ShardedDB(
            ksize=21, scaled=30, canonical=True, seed=123, hv_d=d,
            names=[f"g{i}" for i in range(n)], hvs=hv, norms=norms,
        )

    @pytest.mark.parametrize("symmetric", [False, True])
    def test_matches_dense_path(self, symmetric):
        from hypergen_tpu.models.comparator import Comparator, format_ani_report

        rng = np.random.default_rng(21)
        ref = self._db(rng, 37)
        # correlated queries so some pairs clear a high threshold
        q = ref if symmetric else self._db(rng, 23)
        if not symmetric:
            q.hvs[:10] = ref.hvs[:10] + rng.integers(-2, 3, q.hvs[:10].shape)
            q.norms[:10] = np.sum(
                q.hvs[:10].astype(np.int64) ** 2, axis=1
            ).astype(np.int32)
        comp = Comparator(ksize=21, tile_m=16, tile_n=16, int8_split=False)
        for th in (60.0, 85.0, 95.0):
            ri_d, qi_d, ani_d = comp.ani_pairs(ref, q, symmetric=symmetric)
            ri_t, qi_t, ani_t, n_total = comp.ani_pairs_thresholded(
                ref, q, symmetric=symmetric, threshold=th
            )
            assert n_total == len(ani_d)
            tsv_d, _ = format_ani_report(
                ref.names, q.names, ri_d, qi_d, ani_d, th
            )
            tsv_t, _ = format_ani_report(
                ref.names, q.names, ri_t, qi_t, ani_t, th
            )
            assert tsv_d == tsv_t

    def test_mxu_presplit_preload_matches_cpu_path(self):
        """int8-split comparator (preloaded tiles stored as presplit int8
        planes) produces identical pairs to the direct int32 CPU path —
        covers the tuple-block branches of thresholded AND streamed."""
        from hypergen_tpu.models.comparator import Comparator

        rng = np.random.default_rng(35)
        ref = self._db(rng, 37)
        cm = Comparator(ksize=21, tile_m=16, tile_n=16, int8_split=True)
        cc = Comparator(ksize=21, tile_m=16, tile_n=16, int8_split=False)
        th = 60.0
        for fn in ("ani_pairs_thresholded", "ani_pairs_streamed"):
            rm, qm, am, nm = getattr(cm, fn)(ref, ref, True, th)
            rc, qc, ac, nc = getattr(cc, fn)(ref, ref, True, th)
            assert nm == nc
            np.testing.assert_array_equal(rm, rc)
            np.testing.assert_array_equal(qm, qc)
            np.testing.assert_array_equal(am, ac)

    @pytest.mark.parametrize("symmetric", [False, True])
    def test_streamed_matches_dense_path(self, symmetric):
        """Host-filtered streamed pairs == full dense table + filter."""
        from hypergen_tpu.models.comparator import Comparator

        rng = np.random.default_rng(33)
        ref = self._db(rng, 37)
        q = ref if symmetric else self._db(rng, 23)
        comp = Comparator(ksize=21, tile_m=16, tile_n=16, int8_split=False)
        for th in (0.0, 60.0, 85.0):
            ri_d, qi_d, ani_d = comp.ani_pairs(ref, q, symmetric=symmetric)
            ri_s, qi_s, ani_s, n_total = comp.ani_pairs_streamed(
                ref, q, symmetric=symmetric, threshold=th
            )
            assert n_total == len(ani_d)
            keep = ani_d >= np.float32(th)
            np.testing.assert_array_equal(ri_s, ri_d[keep])
            np.testing.assert_array_equal(qi_s, qi_d[keep])
            np.testing.assert_array_equal(ani_s, ani_d[keep])

    @pytest.mark.parametrize("path", ["thresholded", "streamed"])
    def test_symmetric_offsets_match_global(self, path):
        """Pod-style per-rectangle calls with global offsets reproduce the
        single-call symmetric pair set exactly."""
        import dataclasses

        from hypergen_tpu.models.comparator import Comparator

        rng = np.random.default_rng(34)
        db = self._db(rng, 37)
        th = 60.0
        comp = Comparator(ksize=21, tile_m=16, tile_n=16, int8_split=False)
        fn = (
            comp.ani_pairs_thresholded if path == "thresholded"
            else comp.ani_pairs_streamed
        )
        ri_g, qi_g, ani_g, _ = fn(db, db, symmetric=True, threshold=th)
        rows = []
        for lo, hi in ((0, 19), (19, 37)):
            part = dataclasses.replace(
                db, names=db.names[lo:hi], hvs=db.hvs[lo:hi],
                norms=db.norms[lo:hi],
            )
            for qlo, qhi in ((0, 20), (20, 37)):
                qpart = dataclasses.replace(
                    db, names=db.names[qlo:qhi], hvs=db.hvs[qlo:qhi],
                    norms=db.norms[qlo:qhi],
                )
                ri, qi, ani, _ = fn(
                    part, qpart, symmetric=True, threshold=th,
                    ref_offset=lo, query_offset=qlo,
                )
                rows.append((ri + lo, qi + qlo, ani))
        ri = np.concatenate([r[0] for r in rows])
        qi = np.concatenate([r[1] for r in rows])
        ani = np.concatenate([r[2] for r in rows])
        order = np.lexsort((qi, ri))
        np.testing.assert_array_equal(ri[order], ri_g)
        np.testing.assert_array_equal(qi[order], qi_g)
        np.testing.assert_array_equal(ani[order], ani_g)

    def test_cap_overflow_retries(self):
        from hypergen_tpu.models.comparator import Comparator

        rng = np.random.default_rng(5)
        ref = self._db(rng, 40)
        comp = Comparator(ksize=21, tile_m=64, tile_n=64, int8_split=False)
        comp.compact_cap0 = 64  # force the overflow-retry loop
        # threshold 50 keeps ~everything among self-similar rows
        db2 = self._db(rng, 40)
        db2.hvs[:] = ref.hvs + rng.integers(-1, 2, ref.hvs.shape)
        db2.norms[:] = np.sum(
            db2.hvs.astype(np.int64) ** 2, axis=1
        ).astype(np.int32)
        ri, qi, ani, n_total = comp.ani_pairs_thresholded(
            ref, db2, symmetric=False, threshold=50.0
        )
        ri_d, qi_d, ani_d = comp.ani_pairs(ref, db2, symmetric=False)
        keep = ani_d >= np.float32(50.0)
        np.testing.assert_array_equal(ri, ri_d[keep])
        np.testing.assert_array_equal(qi, qi_d[keep])
        np.testing.assert_array_equal(ani, ani_d[keep])


class TestI16WrapParity:
    def test_encode_wraps_like_reference_beyond_32767_hashes(self):
        """SURVEY hard-part: the reference accumulates the HV in i16 with
        overflow-checks=false, so n_hashes > 32767 wraps (a ~50 Mbp genome
        at scaled=1500). Device encode must wrap identically to the oracle."""
        from hypergen_tpu.ops.u64 import from_np_u64

        rng = np.random.default_rng(77)
        n = 40_000  # > i16 max
        hashes = rng.integers(0, 1 << 63, size=n, dtype=np.uint64)
        D = 128
        exp = orp.encode_hash_hd([int(h) for h in hashes], D)
        assert exp.dtype == np.int16
        h = from_np_u64(hashes.reshape(1, n))
        valid = jnp.ones((1, n), dtype=bool)
        got32 = encode_hv(h, valid, D, block=512)
        got = np.asarray(hv_to_i16(got32))[0]
        np.testing.assert_array_equal(got, exp)
        # the init -(n) itself wraps: spot-check an all-invalid tail too
        assert exp.min() < 0 or exp.max() >= 0  # sanity: values exist
