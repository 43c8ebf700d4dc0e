"""Tests for FASTA I/O, BitPacker8x-compatible packing, and .sketch format."""

import gzip

import numpy as np
import pytest

from hypergen_tpu.io.bitpack import compress_hv, find_quant_bits, pack_hv, unpack_hv
from hypergen_tpu.io.fastx import (
    codes_from_records,
    get_fasta_files,
    read_fasta_records,
    read_genome_codes,
    seq_to_codes,
)
from hypergen_tpu.io.sketch_db import (
    FileSketch,
    ShardedDB,
    dump_sharded_db,
    dump_sketch,
    load_sharded_db,
    load_sketch,
    sketches_to_db,
)

# the reference repo's only fixture (reference:test/test.fna), held here so
# the test needs no checkout of the reference
REFERENCE_FIXTURE = b">test\nAGCTCTTANNAGCCCNTTacgttacagccctgaaaacttttest.fna\n"

rng = np.random.default_rng(3)


class TestFastx:
    def test_seq_to_codes(self):
        codes = seq_to_codes(b"ACGTacgtNnU-x")
        np.testing.assert_array_equal(
            codes, [0, 1, 2, 3, 0, 1, 2, 3, 4, 4, 3, 4, 4]
        )

    def test_read_fasta_multi_record(self, tmp_path):
        p = tmp_path / "x.fna"
        p.write_bytes(b">r1 desc\nACGT\nACGT\n\n>r2\nTTTT\n")
        recs = read_fasta_records(p)
        assert recs == [(b"r1 desc", b"ACGTACGT"), (b"r2", b"TTTT")]
        codes = codes_from_records(recs)
        # records joined by one INVALID separator
        np.testing.assert_array_equal(
            codes, [0, 1, 2, 3, 0, 1, 2, 3, 4, 3, 3, 3, 3]
        )

    def test_read_gzip(self, tmp_path):
        p = tmp_path / "x.fna.gz"
        p.write_bytes(gzip.compress(b">r\nACGT\n"))
        assert read_fasta_records(p) == [(b"r", b"ACGT")]

    def test_reference_fixture(self, tmp_path):
        p = tmp_path / "test.fna"
        p.write_bytes(REFERENCE_FIXTURE)
        recs = read_fasta_records(p)
        assert len(recs) == 1
        assert recs[0][1].startswith(b"AGCTCTTANN")

    def test_read_genome_codes_crlf(self, tmp_path):
        p = tmp_path / "x.fa"
        p.write_bytes(b">r\r\nACGT\r\nGG\r\n")
        np.testing.assert_array_equal(read_genome_codes(p), [0, 1, 2, 3, 2, 2])

    def test_get_fasta_files_order(self, tmp_path):
        for name in ["b.fa", "a.fna", "c.fasta", "z.txt"]:
            (tmp_path / name).write_bytes(b">r\nA\n")
        files = [f.name for f in get_fasta_files(tmp_path)]
        assert files == ["a.fna", "b.fa", "c.fasta"]  # extension order first

    def test_missing_header_raises(self, tmp_path):
        p = tmp_path / "bad.fna"
        p.write_bytes(b"ACGT\n")
        with pytest.raises(ValueError):
            read_fasta_records(p)


class TestBitpack:
    @pytest.mark.parametrize("bits", range(6, 17))
    def test_roundtrip_all_widths(self, bits):
        D = 1024
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        hv = rng.integers(lo, hi + 1, size=D).astype(np.int16)
        hv[0], hv[1] = lo, hi  # pin the extremes
        packed = pack_hv(hv, bits)
        assert len(packed) == bits * D // 8
        out = unpack_hv(packed, bits, D)
        np.testing.assert_array_equal(out, hv)

    def test_quant_bit_search(self):
        assert find_quant_bits(np.array([0, 1, -1], dtype=np.int16)) == 6
        assert find_quant_bits(np.array([-32, 31], dtype=np.int16)) == 6
        assert find_quant_bits(np.array([-33, 0], dtype=np.int16)) == 7
        assert find_quant_bits(np.array([0, 32], dtype=np.int16)) == 7
        assert find_quant_bits(np.array([-512, 511], dtype=np.int16)) == 10
        assert find_quant_bits(np.array([-32768, 32767], dtype=np.int16)) == 16
        # width saturates at 16 even though the loop can't cover more
        assert find_quant_bits(np.array([32767], dtype=np.int16)) == 16

    def test_compress_picks_minimal_bits(self):
        hv = rng.integers(-100, 100, size=512).astype(np.int16)
        packed, bits = compress_hv(hv)
        assert bits == find_quant_bits(hv)
        np.testing.assert_array_equal(unpack_hv(packed, bits, 512), hv)

    def test_block_layout_vertical(self):
        """Pin the SIMD-BP vertical layout: value i -> lane i%8, pos i//8."""
        D = 256
        hv = np.zeros(D, dtype=np.int16)
        hv[8] = 1  # lane 0, j=1 -> lane-0 stream bit [1*b, 2*b)
        bits = 6  # offset 32 -> packed value 33; hv[8] -> 33+... wait
        packed = pack_hv(hv, bits)
        words = np.frombuffer(packed, dtype="<u4").reshape(bits, 8)
        # lane 0 stream: j=0 value=32 (offset), j=1 value=33, j>=2 value=32
        lane0 = int(words[0, 0])
        assert lane0 & 0x3F == 32  # j=0 -> bits [0,6)
        assert (lane0 >> 6) & 0x3F == 33  # j=1 -> bits [6,12)

    def test_non_multiple_of_256_rejected(self):
        with pytest.raises(ValueError):
            pack_hv(np.zeros(100, dtype=np.int16), 8)


class TestSketchDB:
    def _mk_sketch(self, name="g1.fna", d=512):
        hv = rng.integers(-200, 200, size=d).astype(np.int16)
        norm2 = int(np.sum(hv.astype(np.int64) ** 2))
        return (
            FileSketch.from_dense(hv, norm2, name, 21, 1500, True, 123),
            hv,
            norm2,
        )

    def test_sketch_roundtrip(self, tmp_path):
        s1, hv1, n1 = self._mk_sketch("a.fna")
        s2, hv2, n2 = self._mk_sketch("b.fna")
        p = tmp_path / "db.sketch"
        dump_sketch([s1, s2], p)
        loaded = load_sketch(p)
        assert len(loaded) == 2
        for orig_hv, ld in zip([hv1, hv2], loaded):
            assert (ld.ksize, ld.scaled, ld.canonical, ld.seed) == (21, 1500, True, 123)
            np.testing.assert_array_equal(ld.decompress(), orig_hv)

    def test_binary_layout_bincode(self, tmp_path):
        """Pin the exact bincode legacy byte layout."""
        hv = np.zeros(256, dtype=np.int16)
        s = FileSketch.from_dense(hv, 0, "x", 21, 1500, True, 123)
        p = tmp_path / "one.sketch"
        dump_sketch([s], p)
        blob = p.read_bytes()
        assert blob[:8] == (1).to_bytes(8, "little")  # Vec len
        assert blob[8] == 21  # ksize u8
        assert blob[9:17] == (1500).to_bytes(8, "little")  # scaled u64
        assert blob[17] == 1  # canonical bool
        assert blob[18:26] == (123).to_bytes(8, "little")  # seed u64
        assert blob[26:34] == (256).to_bytes(8, "little")  # hv_d usize
        assert blob[34] == 6  # quant bits for all-zero hv
        assert blob[35:39] == (0).to_bytes(4, "little")  # norm2 i32
        assert blob[39:47] == (1).to_bytes(8, "little")  # name len
        assert blob[47:48] == b"x"
        hv_len = int.from_bytes(blob[48:56], "little")
        assert hv_len == 6 * 256 // 16  # packed i16 count
        assert len(blob) == 56 + 2 * hv_len

    def test_norm2_negative_roundtrip(self, tmp_path):
        s, _, _ = self._mk_sketch()
        s.hv_norm_2 = -123456
        p = tmp_path / "n.sketch"
        dump_sketch([s], p)
        assert load_sketch(p)[0].hv_norm_2 == -123456

    def test_sharded_db_roundtrip(self, tmp_path):
        sketches = [self._mk_sketch(f"g{i}.fna")[0] for i in range(7)]
        db = sketches_to_db(sketches)
        dump_sharded_db(db, tmp_path / "db.hgdb", n_shards=3)
        back = load_sharded_db(tmp_path / "db.hgdb")
        assert back.names == [f"g{i}.fna" for i in range(7)]
        np.testing.assert_array_equal(back.hvs, db.hvs)
        np.testing.assert_array_equal(back.norms, db.norms)
        # partial shard load
        part = load_sharded_db(tmp_path / "db.hgdb", shard_ids=[1])
        assert len(part.names) == part.hvs.shape[0] > 0


class TestLoadDbRows:
    def test_row_ranges_across_shards(self, tmp_path):
        from hypergen_tpu.io.sketch_db import (
            ShardedDB, dump_sharded_db, load_db_rows,
        )

        rng = np.random.default_rng(8)
        M, D = 23, 64
        hv = rng.integers(-9, 9, size=(M, D)).astype(np.int16)
        norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)
        db = ShardedDB(ksize=21, scaled=30, canonical=True, seed=123,
                       hv_d=D, names=[f"g{i}" for i in range(M)],
                       hvs=hv, norms=norms)
        dump_sharded_db(db, tmp_path / "db.hgdb", n_shards=4)
        for lo, hi in [(0, 5), (4, 13), (0, 23), (20, 23), (7, 7)]:
            part = load_db_rows(tmp_path / "db.hgdb", lo, hi)
            np.testing.assert_array_equal(part.hvs, hv[lo:hi])
            np.testing.assert_array_equal(part.norms, norms[lo:hi])
            assert part.names == db.names[lo:hi]
