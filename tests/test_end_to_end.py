"""End-to-end pipeline tests: files -> sketch -> .sketch -> dist TSV.

Mirrors the reference's load-bearing test pattern (SURVEY §4): numeric
parity between the fast path and the scalar oracle, plus full-CLI flows on
the reference's own fixture (reference:test/test.fna).
"""

import numpy as np
import pytest

from hypergen_tpu.cli import main as cli_main
from hypergen_tpu.io.fastx import read_fasta_records, seq_to_codes
from hypergen_tpu.io.sketch_db import load_sketch, sketches_to_db
from hypergen_tpu.models.comparator import ani_f32_host
from hypergen_tpu.models.sketcher import Sketcher
from hypergen_tpu.oracle import pipeline as orp
from hypergen_tpu.params import SketchParams

# the reference repo's only fixture (reference:test/test.fna), held here so
# the test needs no checkout of the reference
REFERENCE_FIXTURE = b">test\nAGCTCTTANNAGCCCNTTacgttacagccctgaaaacttttest.fna\n"

rng = np.random.default_rng(11)


def _write_genome(path, length, seed, mutate_from=None, mut_rate=0.0):
    r = np.random.default_rng(seed)
    if mutate_from is None:
        seq = r.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=length)
    else:
        seq = mutate_from.copy()
        flips = r.random(seq.shape[0]) < mut_rate
        seq[flips] = r.choice(np.frombuffer(b"ACGT", dtype=np.uint8),
                              size=int(flips.sum()))
    lines = [b">g", *(seq[i : i + 70].tobytes() for i in range(0, len(seq), 70))]
    path.write_bytes(b"\n".join(lines) + b"\n")
    return seq


@pytest.fixture(scope="module")
def small_params():
    # small chunk + low scaled so tiny test genomes produce hashes
    return SketchParams(ksize=21, seed=123, scaled=30, hv_d=1024)


class TestSketcherParity:
    def test_sketcher_matches_oracle_single_genome(self, small_params, tmp_path):
        seq = _write_genome(tmp_path / "g.fna", 5000, seed=1)
        sk = Sketcher(small_params, chunk_positions=512)
        fs = sk.sketch_file(tmp_path / "g.fna")
        oracle = orp.sketch_genome(
            [seq.tobytes()], ksize=21, scaled=30, seed=123, hv_d=1024
        )
        np.testing.assert_array_equal(fs.decompress(), oracle["hv"])
        assert fs.hv_norm_2 == oracle["norm2"]

    def test_sketcher_multi_record_and_case(self, tmp_path):
        p = tmp_path / "m.fna"
        p.write_bytes(b">r1\nacgtACGTNNacgtacgtACGTACGTacgt\n>r2\n"
                      + b"GATTACA" * 40 + b"\n")
        params = SketchParams(ksize=21, seed=123, scaled=2, hv_d=1024)
        sk = Sketcher(params, chunk_positions=256)
        fs = sk.sketch_file(p)
        recs = read_fasta_records(p)
        oracle = orp.sketch_genome(
            [r[1] for r in recs], ksize=21, scaled=2, seed=123, hv_d=1024
        )
        np.testing.assert_array_equal(fs.decompress(), oracle["hv"])
        assert oracle["hashes"], "fixture should produce hashes"

    def test_reference_fixture_sketch(self, tmp_path):
        """reference:test/test.fna end-to-end with scaled=1 (tiny record)."""
        (tmp_path / "t.fna").write_bytes(REFERENCE_FIXTURE)
        params = SketchParams(ksize=21, seed=123, scaled=1, hv_d=1024)
        sk = Sketcher(params, chunk_positions=128)
        fs = sk.sketch_file(tmp_path / "t.fna")
        recs = read_fasta_records(tmp_path / "t.fna")
        oracle = orp.sketch_genome(
            [r[1] for r in recs], ksize=21, scaled=1, seed=123, hv_d=1024
        )
        assert fs.hv_norm_2 == oracle["norm2"]
        np.testing.assert_array_equal(fs.decompress(), oracle["hv"])
        assert len(oracle["hashes"]) > 0

    def test_chunk_boundary_invariance(self, small_params, tmp_path):
        """Same genome, different chunk sizes -> identical sketch."""
        _write_genome(tmp_path / "g.fna", 3000, seed=5)
        outs = []
        for C in (128, 512, 4096):
            sk = Sketcher(small_params, chunk_positions=C)
            outs.append(sk.sketch_file(tmp_path / "g.fna"))
        for fs in outs[1:]:
            np.testing.assert_array_equal(fs.decompress(), outs[0].decompress())
            assert fs.hv_norm_2 == outs[0].hv_norm_2

    def test_mmhash_method_end_to_end(self, tmp_path):
        seq = _write_genome(tmp_path / "g.fna", 4000, seed=9)
        params = SketchParams(ksize=21, seed=123, scaled=20, hv_d=512,
                              sketch_method="mmhash")
        sk = Sketcher(params, chunk_positions=512)
        fs = sk.sketch_file(tmp_path / "g.fna")
        oracle = orp.sketch_genome(
            [seq.tobytes()], ksize=21, scaled=20, seed=123, hv_d=512,
            method="mmhash",
        )
        np.testing.assert_array_equal(fs.decompress(), oracle["hv"])


class TestCliFlows:
    def _mk_dataset(self, tmp_path, n=4, length=4000):
        tmp_path.mkdir(parents=True, exist_ok=True)
        base = None
        for i in range(n):
            base = _write_genome(
                tmp_path / f"g{i}.fna", length, seed=100 + i,
                mutate_from=base if i else None, mut_rate=0.02,
            )
        return tmp_path

    def test_sketch_dist_cli(self, tmp_path):
        data = self._mk_dataset(tmp_path / "data")
        out_sketch = tmp_path / "db.sketch"
        # -D cpu exercises the forced-CPU backend path (a no-op here since
        # conftest already pins CPU, but it keeps the flag wired end-to-end)
        cli_main([
            "sketch", "-p", str(data), "-o", str(out_sketch),
            "-s", "30", "-d", "1024", "-D", "cpu",
        ])
        sketches = load_sketch(out_sketch)
        assert len(sketches) == 4
        assert sketches[0].hv_d == 1024

        out_tsv = tmp_path / "ani.tsv"
        cli_main([
            "dist", "-r", str(out_sketch), "-q", str(out_sketch),
            "-o", str(out_tsv), "-a", "50.0",
        ])
        rows = [l.split("\t") for l in out_tsv.read_text().splitlines()]
        assert rows, "mutated genomes should pass a 50% threshold"
        anis = [float(r[2]) for r in rows]
        assert anis == sorted(anis, reverse=True)
        # symmetric: n(n-1)/2 pairs max
        assert len(rows) <= 6

    def test_dist_matches_oracle_tsv(self, tmp_path):
        data = self._mk_dataset(tmp_path / "data", n=3)
        out_sketch = tmp_path / "db.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(out_sketch),
                  "-s", "30", "-d", "1024"])
        out_tsv = tmp_path / "ani.tsv"
        cli_main(["dist", "-r", str(out_sketch), "-q", str(out_sketch),
                  "-o", str(out_tsv), "-a", "0.0"])

        # oracle recomputation of every pair from decompressed HVs
        db = sketches_to_db(load_sketch(out_sketch))
        exp_rows = {}
        for i in range(3):
            for j in range(i + 1, 3):
                ani = orp.compute_pairwise_ani(
                    db.hvs[i], int(db.norms[i]), db.hvs[j], int(db.norms[j]), 21
                )
                exp_rows[(db.names[i], db.names[j])] = f"{ani:.3f}"
        got = {}
        for line in out_tsv.read_text().splitlines():
            r, q, a = line.split("\t")
            got[(r, q)] = a
        assert got == exp_rows

    def test_search_cli(self, tmp_path):
        data = self._mk_dataset(tmp_path / "data", n=4)
        out_sketch = tmp_path / "db.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(out_sketch),
                  "-s", "30", "-d", "1024"])
        out_tsv = tmp_path / "hits.tsv"
        cli_main(["search", "-r", str(out_sketch), "-q", str(out_sketch),
                  "-o", str(out_tsv), "-a", "50.0", "--top_k", "2"])
        lines = out_tsv.read_text().splitlines()
        assert lines
        # self-hit must rank first with ANI 100
        first = lines[0].split("\t")
        assert first[0] == first[1]
        assert float(first[2]) == pytest.approx(100.0)

    def test_sketch_hgdb_output(self, tmp_path):
        data = self._mk_dataset(tmp_path / "data", n=3)
        out_db = tmp_path / "db.hgdb"
        cli_main(["sketch", "-p", str(data), "-o", str(out_db),
                  "-s", "30", "-d", "1024", "--shards", "2"])
        from hypergen_tpu.io.sketch_db import load_sharded_db

        db = load_sharded_db(out_db)
        assert db.hvs.shape == (3, 1024)
        out_tsv = tmp_path / "ani.tsv"
        cli_main(["dist", "-r", str(out_db), "-q", str(out_db),
                  "-o", str(out_tsv), "-a", "50.0"])
        assert out_tsv.exists()


class TestHostAniMap:
    def test_host_map_matches_oracle_exactly(self):
        r = np.random.default_rng(0)
        dots = r.integers(-(1 << 20), 1 << 20, size=50).astype(np.int32)
        nr = r.integers(1, 1 << 20, size=50).astype(np.int32)
        nq = r.integers(1, 1 << 20, size=50).astype(np.int32)
        full = ani_f32_host(dots[:, None], nr, nq[:1], 21)
        for i in range(50):
            exp = orp.ani_from_dot(int(dots[i]), int(nr[i]), int(nq[0]), 21)
            assert float(full[i, 0]) == exp  # bit-identical f32

class TestHistogram:
    def test_hv_histogram_counts(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        _write_genome(data / "g0.fna", 4000, seed=5)
        out_sketch = tmp_path / "db.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(out_sketch),
                  "-s", "30", "-d", "1024"])
        from hypergen_tpu.io.sketch_db import hv_value_histogram

        sketches = load_sketch(out_sketch)
        hist = hv_value_histogram(sketches)
        assert sum(hist.values()) == 1024
        dense = sketches[0].decompress()
        for v, c in hist.items():
            assert int(np.sum(dense == v)) == c

    def test_hist_cli(self, tmp_path, capsys):
        data = tmp_path / "data"
        data.mkdir()
        _write_genome(data / "g0.fna", 4000, seed=6)
        out_sketch = tmp_path / "db.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(out_sketch),
                  "-s", "30", "-d", "1024"])
        cli_main(["hist", "-r", str(out_sketch)])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines and all(len(l.split("\t")) == 2 for l in lines)
        assert sum(int(l.split("\t")[1]) for l in lines) == 1024

class TestResume:
    def test_resume_skips_done_and_appends(self, tmp_path):
        from hypergen_tpu.io.sketch_db import load_sharded_db

        data = tmp_path / "data"
        data.mkdir()
        for i in range(3):
            _write_genome(data / f"g{i}.fna", 4000, seed=40 + i)
        out = tmp_path / "db.hgdb"
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "30", "-d", "1024"])
        db1 = load_sharded_db(out)
        # add two more genomes, resume
        for i in range(3, 5):
            _write_genome(data / f"g{i}.fna", 4000, seed=40 + i)
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "30", "-d", "1024", "--resume"])
        db2 = load_sharded_db(out)
        assert len(db2.names) == 5
        # previously sketched rows unchanged
        for i, name in enumerate(db1.names):
            j = db2.names.index(name)
            np.testing.assert_array_equal(db1.hvs[i], db2.hvs[j])
        # appended rows equal a fresh full sketch
        out3 = tmp_path / "fresh.hgdb"
        cli_main(["sketch", "-p", str(data), "-o", str(out3),
                  "-s", "30", "-d", "1024"])
        db3 = load_sharded_db(out3)
        for name in db3.names:
            np.testing.assert_array_equal(
                db2.hvs[db2.names.index(name)],
                db3.hvs[db3.names.index(name)],
            )

    def test_resume_path_spelling_insensitive(self, tmp_path):
        """Resume keyed on resolved paths: a different spelling of the same
        input directory must not re-sketch or duplicate DB rows."""
        from hypergen_tpu.io.sketch_db import load_sharded_db

        data = tmp_path / "data"
        data.mkdir()
        for i in range(2):
            _write_genome(data / f"g{i}.fna", 4000, seed=70 + i)
        out = tmp_path / "db.hgdb"
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "30", "-d", "1024"])
        respelled = tmp_path / "data" / ".." / "data"
        cli_main(["sketch", "-p", str(respelled), "-o", str(out),
                  "-s", "30", "-d", "1024", "--resume"])
        db = load_sharded_db(out)
        assert len(db.names) == 2

    def test_resume_cwd_independent(self, tmp_path, monkeypatch):
        """Resume from a DIFFERENT working directory after sketching with
        relative input paths must still match (the manifest records
        absolute resolved_names written in the original cwd; r2 advisor)."""
        from hypergen_tpu.io.sketch_db import load_sharded_db

        data = tmp_path / "data"
        data.mkdir()
        for i in range(2):
            _write_genome(data / f"g{i}.fna", 4000, seed=80 + i)
        out = tmp_path / "db.hgdb"
        monkeypatch.chdir(tmp_path)
        cli_main(["sketch", "-p", "data", "-o", str(out),
                  "-s", "30", "-d", "1024"])
        other = tmp_path / "elsewhere"
        other.mkdir()
        # decoy: a same-named relative dir in the NEW cwd must not match
        (other / "data").mkdir()
        monkeypatch.chdir(other)
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "30", "-d", "1024", "--resume"])
        db = load_sharded_db(out)
        assert len(db.names) == 2  # nothing re-sketched, no duplicates

    def test_resume_prefield_backfill_stays_relative(self, tmp_path,
                                                     monkeypatch):
        """Backfilling resolved_names into a pre-field manifest must keep
        relative names relative (resolved at READ time), not freeze the
        resume run's cwd as authoritative — a one-time wrong-cwd resume
        would otherwise permanently poison every future resume."""
        import json

        from hypergen_tpu.io.sketch_db import load_sharded_db

        data = tmp_path / "data"
        data.mkdir()
        for i in range(2):
            _write_genome(data / f"g{i}.fna", 4000, seed=90 + i)
        out = tmp_path / "db.hgdb"
        monkeypatch.chdir(tmp_path)
        cli_main(["sketch", "-p", "data", "-o", str(out),
                  "-s", "30", "-d", "1024"])
        # simulate a pre-resolved_names manifest
        mpath = out / "manifest.json"
        manifest = json.loads(mpath.read_text())
        del manifest["resolved_names"]
        mpath.write_text(json.dumps(manifest))
        # resume from the WRONG cwd with one extra genome: old relative
        # names must remain relative in the backfilled manifest
        other = tmp_path / "elsewhere"
        other.mkdir()
        _write_genome(data / "g2.fna", 4000, seed=92)
        monkeypatch.chdir(other)
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "30", "-d", "1024", "--resume"])
        backfilled = json.loads(mpath.read_text())["resolved_names"]
        assert backfilled[:2] == manifest["names"][:2]  # still relative
        # the wrong-cwd resume itself re-sketched (can't match: 2+3 rows) —
        # but a resume from the ORIGINAL cwd must now match every row and
        # append nothing, which the frozen-cwd backfill would break
        monkeypatch.chdir(tmp_path)
        cli_main(["sketch", "-p", "data", "-o", str(out),
                  "-s", "30", "-d", "1024", "--resume"])
        assert len(load_sharded_db(out).names) == 5

    def test_resume_param_mismatch_errors(self, tmp_path):
        data = tmp_path / "data"
        data.mkdir()
        _write_genome(data / "g0.fna", 3000, seed=1)
        out = tmp_path / "db.hgdb"
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "30", "-d", "1024"])
        with pytest.raises(SystemExit):
            cli_main(["sketch", "-p", str(data), "-o", str(out),
                      "-s", "50", "-d", "1024", "--resume"])


class TestDSweep:
    @pytest.mark.parametrize("hv_d", [1024, 4096, 8192])
    def test_sketch_matches_oracle_across_d(self, hv_d, tmp_path):
        """BASELINE config 3: D-sweep parity (1024/4096/8192)."""
        seq = _write_genome(tmp_path / "g.fna", 4000, seed=11)
        p = SketchParams(ksize=21, seed=123, scaled=30, hv_d=hv_d)
        sk = Sketcher(p, chunk_positions=1024, batch=1)
        fs = sk.sketch_file(tmp_path / "g.fna")
        oracle = orp.sketch_genome(
            [seq.tobytes()], ksize=21, scaled=30, seed=123, hv_d=hv_d
        )
        np.testing.assert_array_equal(fs.decompress(), oracle["hv"])

class TestAniQuality:
    def test_ani_tracks_mutation_distance(self, tmp_path):
        """BASELINE config 3 quality check: estimated ANI must decrease
        monotonically with mutation rate and land near 100*(1-rate)."""
        data = tmp_path / "q"
        data.mkdir()
        rng = np.random.default_rng(31)
        base = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=60_000)
        rates = [0.0, 0.01, 0.02, 0.04, 0.08]
        for i, rate in enumerate(rates):
            seq = base.copy()
            f = rng.random(seq.size) < rate
            seq[f] = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                size=int(f.sum()))
            (data / f"m{i}.fna").write_bytes(b">m\n" + seq.tobytes() + b"\n")
        out = tmp_path / "db.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "100", "-d", "4096"])
        tsv = tmp_path / "ani.tsv"
        cli_main(["dist", "-r", str(out), "-q", str(out),
                  "-o", str(tsv), "-a", "0.0"])
        import pathlib

        got = {}
        for line in tsv.read_text().splitlines():
            r, q, a = line.split("\t")
            got[(pathlib.Path(r).name, pathlib.Path(q).name)] = float(a)
        anis = [got.get(("m0.fna", f"m{i}.fna"), got.get((f"m{i}.fna", "m0.fna")))
                for i in range(1, len(rates))]
        # monotone decreasing with mutation rate
        assert all(a > b for a, b in zip(anis, anis[1:])), anis
        # within ~1 ANI point of the true identity; substitution with a
        # uniform random base is silent 1/4 of the time
        for rate, a in zip(rates[1:], anis):
            assert abs(a - 100.0 * (1.0 - 0.75 * rate)) < 1.2, (rate, a)

class TestUncompressed:
    def test_uncompressed_sketch_roundtrips(self, tmp_path):
        """if_compressed=False stores dense (quant_bits=0 marker); dump ->
        load -> decompress must equal the compressed path's dense HV."""
        seq = _write_genome(tmp_path / "g.fna", 5000, seed=9)
        del seq
        p_c = SketchParams(ksize=21, seed=123, scaled=30, hv_d=1024)
        p_u = SketchParams(ksize=21, seed=123, scaled=30, hv_d=1024,
                           if_compressed=False)
        fs_c = Sketcher(p_c, chunk_positions=512).sketch_file(tmp_path / "g.fna")
        fs_u = Sketcher(p_u, chunk_positions=512).sketch_file(tmp_path / "g.fna")
        assert fs_u.hv_quant_bits == 0
        np.testing.assert_array_equal(fs_u.decompress(), fs_c.decompress())
        from hypergen_tpu.io.sketch_db import dump_sketch

        out = tmp_path / "u.sketch"
        dump_sketch([fs_u], out)
        loaded = load_sketch(out)
        np.testing.assert_array_equal(loaded[0].decompress(), fs_c.decompress())
        db = sketches_to_db(loaded)
        np.testing.assert_array_equal(db.hvs[0], fs_c.decompress())

    def test_validate_rejects_non_256_hv_d(self):
        with pytest.raises(ValueError):
            SketchParams(hv_d=384).validate()

    def test_ksize_above_32_names_the_divergence(self):
        """k <= 32 is a documented divergence from the reference CPU path
        (arbitrary-k t1ha2, reference:src/sketch.rs:90); the error must
        say so and point at PARITY.md, not just state the range."""
        with pytest.raises(ValueError, match="PARITY.md"):
            SketchParams(ksize=33).validate()
        with pytest.raises(ValueError, match="64-bit"):
            SketchParams(ksize=64).validate()


class TestHistogramHgdb:
    def test_hist_cli_on_hgdb(self, tmp_path, capsys):
        data = tmp_path / "data"
        data.mkdir()
        _write_genome(data / "g0.fna", 4000, seed=8)
        out = tmp_path / "db.hgdb"
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "30", "-d", "1024"])
        cli_main(["hist", "-r", str(out)])
        lines = capsys.readouterr().out.strip().splitlines()
        assert lines and sum(int(l.split("\t")[1]) for l in lines) == 1024


class TestCliErrors:
    def test_empty_input_dir_exits(self, tmp_path):
        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(SystemExit):
            cli_main(["sketch", "-p", str(empty), "-o",
                      str(tmp_path / "x.sketch")])

    def test_ksize_mismatch_exits(self, tmp_path):
        data = tmp_path / "d"
        data.mkdir()
        _write_genome(data / "g.fna", 3000, seed=2)
        a, b = tmp_path / "a.sketch", tmp_path / "b.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(a), "-s", "30",
                  "-d", "1024", "-k", "21"])
        cli_main(["sketch", "-p", str(data), "-o", str(b), "-s", "30",
                  "-d", "1024", "-k", "31"])
        with pytest.raises(SystemExit):
            cli_main(["dist", "-r", str(a), "-q", str(b),
                      "-o", str(tmp_path / "o.tsv")])

    def test_missing_sketch_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            cli_main(["dist", "-r", str(tmp_path / "no.sketch"),
                      "-q", str(tmp_path / "no.sketch"),
                      "-o", str(tmp_path / "o.tsv")])

class TestEdgeGenomes:
    def test_all_n_genome(self, tmp_path):
        """A genome of only Ns yields an all-zero HV and zero hashes."""
        data = tmp_path / "d"
        data.mkdir()
        (data / "n.fna").write_bytes(b">n\n" + b"N" * 500 + b"\n")
        out = tmp_path / "db.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "1", "-d", "256"])
        fs = load_sketch(out)[0]
        assert fs.hv_norm_2 == 0
        np.testing.assert_array_equal(fs.decompress(), np.zeros(256, np.int16))

    def test_genome_shorter_than_k(self, tmp_path):
        data = tmp_path / "d"
        data.mkdir()
        (data / "s.fna").write_bytes(b">s\nACGTACGT\n")  # 8 < k=21
        out = tmp_path / "db.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "1", "-d", "256"])
        fs = load_sketch(out)[0]
        assert fs.hv_norm_2 == 0

    def test_zero_norm_pair_ani_is_zero(self, tmp_path):
        """ANI against an empty sketch is 0 (NaN/-inf -> 0, like the
        reference's NaN guard, reference:src/dist.rs:153-156)."""
        data = tmp_path / "d"
        data.mkdir()
        (data / "a.fna").write_bytes(b">a\n" + b"N" * 200 + b"\n")
        _write_genome(data / "b.fna", 2000, seed=3)
        out = tmp_path / "db.sketch"
        cli_main(["sketch", "-p", str(data), "-o", str(out),
                  "-s", "1", "-d", "256"])
        tsv = tmp_path / "ani.tsv"
        cli_main(["dist", "-r", str(out), "-q", str(out),
                  "-o", str(tsv), "-a", "0.0"])
        rows = [l.split("\t") for l in tsv.read_text().splitlines()]
        assert len(rows) == 1
        assert float(rows[0][2]) == 0.0

class TestStreamingSketchFiles:
    def test_many_mixed_size_files_match_individual(self, tmp_path):
        """Streaming read-ahead + bucket grouping with partial flushes must
        reproduce per-file sketching exactly, in input order."""
        data = tmp_path / "d"
        data.mkdir()
        sizes = [800, 5000, 900, 12000, 850, 5100, 11000, 950, 5200, 820,
                 13000, 870]
        paths = []
        for i, L in enumerate(sizes):
            p = data / f"g{i:02d}.fna"
            _write_genome(p, L, seed=200 + i)
            paths.append(p)
        params = SketchParams(ksize=21, seed=123, scaled=30, hv_d=512)
        sk = Sketcher(params, chunk_positions=1024, batch=3)
        out = sk.sketch_files(paths, progress=False, read_ahead=4)
        assert [fs.file_str for fs in out] == [str(p) for p in paths]
        sk2 = Sketcher(params, chunk_positions=1024, batch=1)
        for p, fs in zip(paths, out):
            ref = sk2.sketch_file(p)
            np.testing.assert_array_equal(fs.decompress(), ref.decompress())
            assert fs.hv_norm_2 == ref.hv_norm_2
