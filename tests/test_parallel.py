"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from hypergen_tpu.models.comparator import ani_f32_host
from hypergen_tpu.ops.ani import dot_i16_exact
from hypergen_tpu.parallel.mesh import AXIS_DB, AXIS_Q, make_mesh
from hypergen_tpu.parallel.search import sharded_topk_search

rng = np.random.default_rng(21)


def _mk_db(m, d=512):
    hv = rng.integers(-60, 60, size=(m, d)).astype(np.int16)
    norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)
    return hv, norms


def _reference_topk(db_hv, db_norm, q_hv, q_norm, ksize, k):
    dot = (db_hv.astype(np.int64) @ q_hv.astype(np.int64).T).astype(np.int32)
    ani = ani_f32_host(dot, db_norm, q_norm, ksize).T  # [n, m]
    idx = np.argsort(-ani, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(ani, idx, axis=1)
    return vals, idx


@pytest.mark.parametrize("mesh_shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
@pytest.mark.needs_devices(8)
def test_sharded_search_matches_single_device(mesh_shape):
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    mesh = make_mesh(*mesh_shape)
    db_hv, db_norm = _mk_db(37)
    q_hv, q_norm = _mk_db(13)
    ani, idx, _dots = sharded_topk_search(
        mesh, db_hv, db_norm, q_hv, q_norm, ksize=21, k_top=5
    )
    exp_vals, exp_idx = _reference_topk(db_hv, db_norm, q_hv, q_norm, 21, 5)
    np.testing.assert_allclose(ani, exp_vals, atol=2e-3)
    # indices may differ only where ANI values tie; check hit sets by value
    for n in range(13):
        got_set = ani[n]
        np.testing.assert_allclose(np.sort(got_set), np.sort(exp_vals[n]), atol=2e-3)


@pytest.mark.needs_devices(8)
def test_sharded_search_self_hits():
    mesh = make_mesh(4, 2)
    db_hv, db_norm = _mk_db(16)
    ani, idx, _dots = sharded_topk_search(
        mesh, db_hv, db_norm, db_hv, db_norm, ksize=21, k_top=1
    )
    np.testing.assert_allclose(ani[:, 0], 100.0, atol=1e-3)
    np.testing.assert_array_equal(idx[:, 0], np.arange(16))


@pytest.mark.needs_devices(8)
def test_sharded_search_k_larger_than_shard():
    """k_top bigger than the per-shard row count must still work (padding)."""
    mesh = make_mesh(8, 1)
    db_hv, db_norm = _mk_db(10)  # ~2 rows per shard, k=4 > shard size
    q_hv, q_norm = _mk_db(3)
    ani, idx, _dots = sharded_topk_search(
        mesh, db_hv, db_norm, q_hv, q_norm, ksize=21, k_top=4
    )
    exp_vals, _ = _reference_topk(db_hv, db_norm, q_hv, q_norm, 21, 4)
    np.testing.assert_allclose(np.sort(ani, 1), np.sort(exp_vals, 1), atol=2e-3)
    assert (idx < 10).all()


@pytest.mark.needs_devices(8)
def test_data_parallel_sketch_encode():
    """Data-parallel HV encode across the q axis via sharding annotations."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax.numpy as jnp

    from hypergen_tpu.ops import u64 as u
    from hypergen_tpu.ops.encode import encode_hv

    mesh = make_mesh(1, 8)
    B, N, D = 8, 64, 256
    hashes = rng.integers(0, 1 << 63, size=(B, N), dtype=np.uint64)
    valid = rng.random((B, N)) < 0.8

    h = u.from_np_u64(hashes)
    sharding = NamedSharding(mesh, P(AXIS_Q, None))
    h_sh = u.U64(jax.device_put(h.hi, sharding), jax.device_put(h.lo, sharding))
    v_sh = jax.device_put(jnp.asarray(valid), sharding)
    got = np.asarray(encode_hv(h_sh, v_sh, D))

    exp = np.asarray(encode_hv(h, jnp.asarray(valid), D))
    np.testing.assert_array_equal(got, exp)


@pytest.mark.needs_devices(8)
def test_sharded_search_1k_db():
    """BASELINE config 4 shape: 1k-genome DB sharded over the mesh,
    streamed query batch, top-hit merge."""
    import jax

    from hypergen_tpu.parallel.mesh import make_mesh
    from hypergen_tpu.parallel.search import sharded_topk_search

    rng = np.random.default_rng(17)
    M, N, D, K = 1000, 64, 512, 5
    db = rng.integers(-40, 40, size=(M, D)).astype(np.int16)
    dbn = np.sum(db.astype(np.int64) ** 2, axis=1).astype(np.int32)
    q = db[rng.integers(0, M, size=N)].copy()
    qn = np.sum(q.astype(np.int64) ** 2, axis=1).astype(np.int32)
    mesh = make_mesh(4, 2)
    ani, idx, _dots = sharded_topk_search(mesh, db, dbn, q, qn, ksize=21, k_top=K)
    exp_ani, exp_idx = _reference_topk(db, dbn, q, qn, 21, K)
    np.testing.assert_allclose(ani, exp_ani, atol=2e-3)
    # self-hit (exact row copy) must rank first with ANI 100
    assert np.allclose(ani[:, 0], 100.0, atol=1e-2)


def test_local_topk_search_tiled():
    """Streaming single-device top-k over DB tiles == one-shot reference."""
    from hypergen_tpu.parallel.search import local_topk_search_tiled

    rng = np.random.default_rng(23)
    M, N, D, K = 530, 16, 256, 7  # deliberately not tile-aligned
    db = rng.integers(-40, 40, size=(M, D)).astype(np.int16)
    dbn = np.sum(db.astype(np.int64) ** 2, axis=1).astype(np.int32)
    q = db[rng.integers(0, M, size=N)].copy()
    qn = np.sum(q.astype(np.int64) ** 2, axis=1).astype(np.int32)
    ani, idx, _dots = local_topk_search_tiled(
        db, dbn, q, qn, ksize=21, k_top=K, tile_m=128, int8_split=False
    )
    exp_ani, _ = _reference_topk(db, dbn, q, qn, 21, K)
    np.testing.assert_allclose(ani, exp_ani, atol=2e-3)
    assert np.allclose(ani[:, 0], 100.0, atol=1e-2)


@pytest.mark.needs_devices(8)
def test_sharded_topk_search_tiled_matches_one_shot():
    """Tiled multi-device streaming (ragged last tile, shared program,
    device-resident queries) == one-shot sharded search."""
    from hypergen_tpu.parallel.search import (
        sharded_topk_search, sharded_topk_search_tiled,
    )

    rng = np.random.default_rng(29)
    M, N, D, K = 333, 12, 256, 6  # M % tile_m != 0 forces a ragged tile
    db = rng.integers(-40, 40, size=(M, D)).astype(np.int16)
    dbn = np.sum(db.astype(np.int64) ** 2, axis=1).astype(np.int32)
    q = db[rng.integers(0, M, size=N)].copy()
    qn = np.sum(q.astype(np.int64) ** 2, axis=1).astype(np.int32)
    mesh = make_mesh(4, 2)
    got = sharded_topk_search_tiled(
        mesh, db, dbn, q, qn, ksize=21, k_top=K, tile_m=100, int8_split=False
    )
    want = sharded_topk_search(
        mesh, db, dbn, q, qn, ksize=21, k_top=K, int8_split=False
    )
    np.testing.assert_allclose(got[0], want[0], atol=2e-3)
    np.testing.assert_array_equal(got[2], want[2])  # exact dots identical
    assert np.allclose(got[0][:, 0], 100.0, atol=1e-2)


def test_maybe_init_distributed_env(monkeypatch):
    """Env triple routes to explicit init; HG_DIST=1 routes to auto-detect;
    no env -> no-op (single-host runs must not touch jax.distributed)."""
    from hypergen_tpu.parallel import mesh as mesh_mod

    calls = []
    monkeypatch.setattr(
        mesh_mod, "init_distributed",
        lambda c, n, p: calls.append(("explicit", c, n, p)),
    )
    monkeypatch.setattr(
        mesh_mod.jax.distributed, "initialize",
        lambda *a, **k: calls.append(("auto",)),
    )
    for var in ("HG_NUM_PROCESSES", "HG_PROCESS_ID", "HG_COORDINATOR",
                "HG_DIST"):
        monkeypatch.delenv(var, raising=False)
    mesh_mod.maybe_init_distributed()
    assert calls == []
    monkeypatch.setenv("HG_NUM_PROCESSES", "2")
    monkeypatch.setenv("HG_PROCESS_ID", "1")
    monkeypatch.setenv("HG_COORDINATOR", "h:1234")
    mesh_mod.maybe_init_distributed()
    assert calls == [("explicit", "h:1234", 2, 1)]
    monkeypatch.setenv("HG_NUM_PROCESSES", "0")
    monkeypatch.setenv("HG_DIST", "1")
    mesh_mod.maybe_init_distributed()
    assert calls[-1] == ("auto",)


class TestSeqPar:
    """Single-genome sequence parallelism (SURVEY §5 long-context row)."""

    def _params(self, **kw):
        from hypergen_tpu.params import SketchParams

        kw = {"ksize": 21, "seed": 123, "scaled": 30, "hv_d": 1024, **kw}
        return SketchParams(**kw)

    def _codes(self, n, seed, with_invalid=True):
        r = np.random.default_rng(seed)
        codes = r.integers(0, 4, size=n).astype(np.uint8)
        if with_invalid:  # N runs spanning chunk boundaries
            codes[5000:5040] = 4
            codes[20470:20490] = 4
        return codes

    @pytest.mark.needs_devices(8)
    def test_matches_single_device(self):
        """A genome sharded over 8 devices == the single-device Sketcher,
        bit for bit (hv, norm2, hash count)."""
        from hypergen_tpu.models.sketcher import Sketcher
        from hypergen_tpu.parallel.seqpar import (
            make_seq_mesh, sketch_codes_seqpar,
        )

        codes = self._codes(40_000, seed=3)
        p = self._params()
        mesh = make_seq_mesh()
        assert mesh.devices.size == 8
        got = sketch_codes_seqpar(codes, p, mesh, chunk_positions=512)
        # n_chunks = ceil((40000-20)/512) = 79 >> one device's share
        ref = Sketcher(p, chunk_positions=512).sketch_codes(codes)
        np.testing.assert_array_equal(got["hv"], ref["hv"])
        assert got["norm2"] == ref["norm2"]
        assert got["n_hashes"] == ref["n_hashes"]

    def test_cross_shard_duplicate_dedup(self):
        """k-mers repeated in far-apart chunks land on different devices;
        global dedup must still count them once."""
        from hypergen_tpu.models.sketcher import Sketcher
        from hypergen_tpu.parallel.seqpar import sketch_codes_seqpar

        r = np.random.default_rng(7)
        block = r.integers(0, 4, size=4096).astype(np.uint8)
        codes = np.concatenate([block] * 8)  # identical content per shard
        p = self._params()
        got = sketch_codes_seqpar(codes, p, chunk_positions=512)
        ref = Sketcher(p, chunk_positions=512).sketch_codes(codes)
        np.testing.assert_array_equal(got["hv"], ref["hv"])
        assert got["n_hashes"] == ref["n_hashes"]

    def test_sketcher_routes_huge_genomes(self, tmp_path):
        """sketch_files sends genomes above seqpar_min_chunks through the
        sharded path; output FileSketches match the batched path exactly."""
        from hypergen_tpu.models.sketcher import Sketcher

        r = np.random.default_rng(13)
        paths = []
        for i, n in enumerate((40_000, 3_000)):  # one huge, one normal
            seq = r.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n)
            p = tmp_path / f"g{i}.fna"
            p.write_bytes(b">g\n" + seq.tobytes() + b"\n")
            paths.append(p)
        p = self._params()
        routed = Sketcher(
            p, chunk_positions=512, seqpar_min_chunks=16
        ).sketch_files(paths, progress=False)
        plain = Sketcher(
            p, chunk_positions=512, seqpar_min_chunks=1 << 30
        ).sketch_files(paths, progress=False)
        for a, b in zip(routed, plain):
            np.testing.assert_array_equal(a.hv, b.hv)
            assert a.hv_norm_2 == b.hv_norm_2

    def test_pallas_kernel_per_shard(self):
        """seqpar (XLA hash path per shard) == the single-device fused
        packed kernel (interpret mode), bit for bit."""
        from hypergen_tpu.models.sketcher import Sketcher
        from hypergen_tpu.parallel.seqpar import sketch_codes_seqpar

        codes = self._codes(9_000, seed=5)
        p = self._params()
        ref = sketch_codes_seqpar(codes, p, chunk_positions=512)
        sk = Sketcher(p, chunk_positions=2048, packed=True)
        assert sk.packed_mode
        got = sk.sketch_codes(codes)
        np.testing.assert_array_equal(got["hv"], ref["hv"])
        assert got["n_hashes"] == ref["n_hashes"]

    def test_capacity_retry(self):
        """scaled=1 keeps every k-mer: tiny initial caps must grow, not drop."""
        from hypergen_tpu.models.sketcher import Sketcher
        from hypergen_tpu.parallel.seqpar import sketch_codes_seqpar

        codes = self._codes(12_000, seed=11, with_invalid=False)
        p = self._params(scaled=1)
        got = sketch_codes_seqpar(codes, p, chunk_positions=512)
        ref = Sketcher(p, chunk_positions=512).sketch_codes(codes)
        np.testing.assert_array_equal(got["hv"], ref["hv"])
        assert got["n_hashes"] == ref["n_hashes"] > 5000


@pytest.mark.needs_devices(8)
def test_sharded_topk_search_tiled():
    """Multi-device streaming top-k over DB tiles == one-shot reference."""
    from hypergen_tpu.parallel.search import sharded_topk_search_tiled

    rng = np.random.default_rng(29)
    M, N, D, K = 530, 16, 256, 7  # deliberately not tile-aligned
    db = rng.integers(-40, 40, size=(M, D)).astype(np.int16)
    dbn = np.sum(db.astype(np.int64) ** 2, axis=1).astype(np.int32)
    q = db[rng.integers(0, M, size=N)].copy()
    qn = np.sum(q.astype(np.int64) ** 2, axis=1).astype(np.int32)
    mesh = make_mesh(4, 2)
    ani, idx, _dots = sharded_topk_search_tiled(
        mesh, db, dbn, q, qn, ksize=21, k_top=K, tile_m=128, int8_split=False,
    )
    exp_ani, _ = _reference_topk(db, dbn, q, qn, 21, K)
    np.testing.assert_allclose(ani, exp_ani, atol=2e-3)
    assert np.allclose(ani[:, 0], 100.0, atol=1e-2)


@pytest.mark.slow
@pytest.mark.needs_devices(8)
def test_gtdb_scale_sharded_search():
    """BASELINE config 5 stand-in: ~50k-genome DB sharded over the mesh,
    top-k >= 85% ANI hits merged with all_gather. Spot-checks planted
    near-duplicates and random rows against the host reference chain."""
    from hypergen_tpu.models.comparator import ani_f32_host
    from hypergen_tpu.ops.ani import dot_i16_exact
    from hypergen_tpu.parallel.mesh import make_mesh
    from hypergen_tpu.parallel.search import sharded_topk_search

    rng = np.random.default_rng(29)
    M, N, D, K = 50_000, 16, 256, 10
    db = rng.integers(-25, 25, size=(M, D)).astype(np.int16)
    # plant one near-duplicate per query deep in the DB
    q = db[rng.integers(0, M, size=N)].copy()
    near_at = rng.integers(M // 2, M, size=N)
    db[near_at] = q + rng.integers(-1, 2, q.shape).astype(np.int16)
    dbn = np.sum(db.astype(np.int64) ** 2, axis=1).astype(np.int32)
    qn = np.sum(q.astype(np.int64) ** 2, axis=1).astype(np.int32)

    mesh = make_mesh(8, 1)
    ani, idx, _dots = sharded_topk_search(mesh, db, dbn, q, qn, ksize=21, k_top=K)
    assert np.allclose(ani[:, 0], 100.0, atol=1e-2)  # exact self rows
    # the planted near-duplicate must appear in the top-k
    for i in range(N):
        assert near_at[i] in idx[i], (i, near_at[i], idx[i])
    # reported ANI values for one query's candidates match the host chain
    import jax.numpy as jnp

    i = 0
    cand = idx[i]
    dot = np.asarray(
        dot_i16_exact(jnp.asarray(db[cand]), jnp.asarray(q[i : i + 1]),
                      int8_split=False)
    )
    exp = ani_f32_host(dot, dbn[cand], qn[i : i + 1], 21)[:, 0]
    np.testing.assert_allclose(ani[i], exp, atol=2e-3)
