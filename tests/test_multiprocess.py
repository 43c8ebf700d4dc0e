"""True multi-process distributed test: 2 CPU processes x 4 devices.

Exercises the multi-host code path (jax.distributed.initialize, global mesh
spanning processes, cross-process collectives in the sharded search) that
the single-process 8-device tests cannot: per-process addressable shards,
cross-host all_gather over the db axis. This is the CPU stand-in for a
2-host deployment.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

_WORKER = textwrap.dedent(
    """
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    coord = sys.argv[3]
    from hypergen_tpu.parallel.mesh import init_distributed, make_mesh
    init_distributed(coord, nproc, pid)
    assert jax.device_count() == 8, jax.device_count()
    assert jax.local_device_count() == 4

    from hypergen_tpu.parallel.search import sharded_topk_search

    rng = np.random.default_rng(0)  # same data on every process
    M, N, D, K = 64, 8, 256, 3
    db = rng.integers(-40, 40, size=(M, D)).astype(np.int16)
    dbn = np.sum(db.astype(np.int64) ** 2, axis=1).astype(np.int32)
    q = db[:N].copy()
    qn = dbn[:N].copy()
    mesh = make_mesh(8, 1)
    ani, idx, _dots = sharded_topk_search(mesh, db, dbn, q, qn, ksize=21, k_top=K)
    assert ani.shape == (N, K) and idx.shape == (N, K)
    assert np.allclose(ani[:, 0], 100.0, atol=1e-2), ani[:, 0]
    assert (idx[:, 0] == np.arange(N)).all(), idx[:, 0]
    print(f"proc{pid} ok", flush=True)
    """
)


@pytest.mark.slow
def test_two_process_sharded_search(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = (
        str(Path(__file__).resolve().parent.parent)
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2", f"localhost:{port}"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        assert f"proc{pid} ok" in out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_WORKER_DB = textwrap.dedent(
    """
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
    db_dir = sys.argv[4]
    from hypergen_tpu.parallel.mesh import init_distributed
    init_distributed(coord, nproc, pid)
    assert jax.device_count() == 8 and jax.local_device_count() == 4

    from hypergen_tpu.io.sketch_db import load_sharded_db
    from hypergen_tpu.parallel.search import multihost_topk_search

    full = load_sharded_db(db_dir)  # test-only reference copy
    N, K = 6, 3
    q = full.hvs[:N].copy(); qn = full.norms[:N].copy()
    ani, idx, _dots = multihost_topk_search(db_dir, q, qn, ksize=21, k_top=K)
    assert ani.shape == (N, K)
    assert np.allclose(ani[:, 0], 100.0, atol=1e-2), ani[:, 0]
    assert (idx[:, 0] == np.arange(N)).all(), idx[:, 0]

    # full reference top-k from the host float chain on the whole DB
    from hypergen_tpu.models.comparator import ani_f32_host
    from hypergen_tpu.ops.ani import dot_i16_exact
    import jax.numpy as jnp
    dot = np.asarray(dot_i16_exact(
        jnp.asarray(full.hvs), jnp.asarray(q), int8_split=False))
    ref = ani_f32_host(dot, full.norms, qn, 21).T  # [N, M]
    exp_ani = -np.sort(-ref, axis=1)[:, :K]
    assert np.allclose(np.asarray(ani), exp_ani, atol=2e-3), (ani, exp_ani)
    print(f"proc{pid} dbsearch ok", flush=True)
    """
)


@pytest.mark.slow
def test_two_process_multihost_db_search(tmp_path):
    from hypergen_tpu.io.sketch_db import ShardedDB, dump_sharded_db

    rng = np.random.default_rng(3)
    M, D = 53, 128  # deliberately not divisible by 8 devices
    hv = rng.integers(-30, 30, size=(M, D)).astype(np.int16)
    norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)
    db = ShardedDB(ksize=21, scaled=30, canonical=True, seed=123, hv_d=D,
                   names=[f"g{i}" for i in range(M)], hvs=hv, norms=norms)
    db_dir = tmp_path / "db.hgdb"
    dump_sharded_db(db, db_dir, n_shards=3)

    port = _free_port()
    script = tmp_path / "worker_db.py"
    script.write_text(_WORKER_DB)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = (
        str(Path(__file__).resolve().parent.parent)
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2",
             f"localhost:{port}", str(db_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
        assert f"proc{pid} dbsearch ok" in out


_WORKER_SKETCH = textwrap.dedent(
    """
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
    data_dir, out_dir = sys.argv[4], sys.argv[5]
    from hypergen_tpu.parallel.mesh import init_distributed
    init_distributed(coord, nproc, pid)

    from hypergen_tpu.cli import main as cli_main
    cli_main(["sketch", "-p", data_dir, "-o", out_dir,
              "-s", "30", "-d", "512"])
    print(f"proc{pid} sketch ok", flush=True)
    """
)


@pytest.mark.slow
def test_two_process_pod_sketch(tmp_path):
    """Pod-mode sketch: per-host file shards -> merged .hgdb == a
    single-process sketch of the same inputs (row order differs by
    round-robin assignment; compared by name)."""
    rng = np.random.default_rng(12)
    data = tmp_path / "genomes"
    data.mkdir()
    for i in range(5):
        seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=3000)
        (data / f"g{i}.fna").write_bytes(b">g\n" + seq.tobytes() + b"\n")

    out = tmp_path / "pod.hgdb"
    port = _free_port()
    script = tmp_path / "worker_sketch.py"
    script.write_text(_WORKER_SKETCH)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = (
        str(Path(__file__).resolve().parent.parent)
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2",
             f"localhost:{port}", str(data), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    for pid, p in enumerate(procs):
        o, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"proc{pid} failed:\n{o}"

    # single-process reference
    from hypergen_tpu.cli import main as cli_main
    from hypergen_tpu.io.sketch_db import load_sharded_db

    ref_out = tmp_path / "single.hgdb"
    cli_main(["sketch", "-p", str(data), "-o", str(ref_out),
              "-s", "30", "-d", "512"])
    pod = load_sharded_db(out)
    ref = load_sharded_db(ref_out)
    assert sorted(pod.names) == sorted(ref.names)
    for name in ref.names:
        np.testing.assert_array_equal(
            pod.hvs[pod.names.index(name)], ref.hvs[ref.names.index(name)]
        )
        assert int(pod.norms[pod.names.index(name)]) == int(
            ref.norms[ref.names.index(name)]
        )


_WORKER_DIST = textwrap.dedent(
    """
    import os, sys
    import jax
    jax.config.update("jax_platforms", "cpu")

    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); coord = sys.argv[3]
    db_dir, out, ani_th = sys.argv[4], sys.argv[5], sys.argv[6]
    from hypergen_tpu.parallel.mesh import init_distributed
    init_distributed(coord, nproc, pid)

    from hypergen_tpu.cli import main as cli_main
    cli_main(["dist", "-r", db_dir, "-q", db_dir, "-o", out, "-a", ani_th])
    print(f"proc{pid} dist ok", flush=True)
    """
)


@pytest.mark.slow
@pytest.mark.parametrize(
    "ref_kind,ani_th",
    [
        ("hgdb", "60"),    # device filter+compact pod path
        ("hgdb", "30"),    # host-filtered streamed pod path (low threshold)
        ("sketch", "60"),  # legacy .sketch ref, row-sliced per host
    ],
)
def test_two_process_pod_dist(tmp_path, ref_kind, ani_th):
    """Pod-mode dist (per-host ref row ranges) == single-process TSV, for
    both threshold regimes and both ref formats."""
    from hypergen_tpu.io.sketch_db import (
        FileSketch, ShardedDB, dump_sharded_db, dump_sketch,
    )

    rng = np.random.default_rng(41)
    M, D = 31, 256
    base = rng.integers(-25, 25, size=(1, D)).astype(np.int16)
    hv = base + rng.integers(-3, 4, size=(M, D)).astype(np.int16)
    norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)
    db = ShardedDB(ksize=21, scaled=30, canonical=True, seed=123, hv_d=D,
                   names=[f"g{i}" for i in range(M)], hvs=hv, norms=norms)
    if ref_kind == "hgdb":
        db_path = tmp_path / "db.hgdb"
        dump_sharded_db(db, db_path, n_shards=3)
    else:
        db_path = tmp_path / "db.sketch"
        dump_sketch(
            [
                FileSketch.from_dense(hv[i], int(norms[i]), f"g{i}", 21, 30,
                                      True, 123)
                for i in range(M)
            ],
            db_path,
        )

    out = tmp_path / "pod_ani.tsv"
    port = _free_port()
    script = tmp_path / "worker_dist.py"
    script.write_text(_WORKER_DIST)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = (
        str(Path(__file__).resolve().parent.parent)
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), "2",
             f"localhost:{port}", str(db_path), str(out), ani_th],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True,
        )
        for pid in range(2)
    ]
    for pid, p in enumerate(procs):
        o, _ = p.communicate(timeout=300)
        assert p.returncode == 0, f"proc{pid} failed:\n{o}"

    from hypergen_tpu.cli import main as cli_main

    ref_out = tmp_path / "single_ani.tsv"
    cli_main(["dist", "-r", str(db_path), "-q", str(db_path),
              "-o", str(ref_out), "-a", ani_th])
    assert out.read_text() == ref_out.read_text()
    assert out.read_text().strip(), f"expected some pairs above {ani_th}"


@pytest.mark.slow
def test_two_process_pod_sketch_resume(tmp_path):
    """Pod resume: existing shards kept as prefix, only new genomes
    sketched; final DB matches a fresh full sketch by name."""
    from hypergen_tpu.io.sketch_db import load_sharded_db

    rng = np.random.default_rng(19)
    data = tmp_path / "genomes"
    data.mkdir()

    def add_genomes(lo, hi):
        for i in range(lo, hi):
            seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=2500)
            (data / f"g{i}.fna").write_bytes(b">g\n" + seq.tobytes() + b"\n")

    def run_pod(extra):
        port = _free_port()
        script = tmp_path / "worker_sketch.py"
        script.write_text(_WORKER_SKETCH.replace(
            '"-s", "30", "-d", "512"]',
            '"-s", "30", "-d", "512"' + extra + ']',
        ))
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["PYTHONPATH"] = (
            str(Path(__file__).resolve().parent.parent)
            + os.pathsep + env.get("PYTHONPATH", "")
        )
        procs = [
            subprocess.Popen(
                [sys.executable, str(script), str(pid), "2",
                 f"localhost:{port}", str(data), str(tmp_path / "pod.hgdb")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
                text=True,
            )
            for pid in range(2)
        ]
        for pid, p in enumerate(procs):
            o, _ = p.communicate(timeout=300)
            assert p.returncode == 0, f"proc{pid} failed:\n{o}"

    add_genomes(0, 3)
    run_pod("")
    db1 = load_sharded_db(tmp_path / "pod.hgdb")
    assert len(db1.names) == 3
    add_genomes(3, 6)
    run_pod(', "--resume"')
    db2 = load_sharded_db(tmp_path / "pod.hgdb")
    assert len(db2.names) == 6
    # original rows unchanged
    for i, name in enumerate(db1.names):
        np.testing.assert_array_equal(
            db1.hvs[i], db2.hvs[db2.names.index(name)]
        )
    # equal to a fresh single-process sketch, by name
    from hypergen_tpu.cli import main as cli_main

    cli_main(["sketch", "-p", str(data), "-o", str(tmp_path / "fresh.hgdb"),
              "-s", "30", "-d", "512"])
    ref = load_sharded_db(tmp_path / "fresh.hgdb")
    assert sorted(db2.names) == sorted(ref.names)
    for name in ref.names:
        np.testing.assert_array_equal(
            db2.hvs[db2.names.index(name)], ref.hvs[ref.names.index(name)]
        )
