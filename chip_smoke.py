#!/usr/bin/env python3
"""Smoke test of the whole user path on NVIDIA GPUs, run from the repo root.

    python3 chip_smoke.py             # one card: every phase below
    python3 chip_smoke.py --cards 4   # only the paths that span four cards

One card, one process (a CPU child process that never opens the card
produces the parity references):

  card     nvidia-smi name and power limit, JAX version, XLA_FLAGS
  data     32 seeded genomes of 1-6 Mbp (~100 Mbp): several contigs each,
           N runs, and a family mutated at 1/2/4% from genome 0
  sketch   `sketch` through the CLI to .sketch and .hgdb; the production
           step's compiled.memory_analysis()
  dist     `dist` at -a 80 (device threshold compaction) and -a 30 (dense
           path): the -a 80 rows are exactly the leading rows of -a 30
  search   a 49,152-row .hgdb built from the sketched HVs by seeded
           perturbation; top-10 `search` of the 32 sketched queries, hits
           byte-equal to a TSV built from exact host dots
  parity   the CPU backend on the same commands (4 genomes sketched, all
           32 for dist): .sketch, .hgdb and both TSVs byte-identical; the
           pure-Python oracle on one short genome
  decide   the fused packed kernel against the XLA step at the production
           bucket (8 x 32 chunks x 131,072 positions) and end to end
           through Sketcher.sketch_files on the same files; the three exact
           dot modes at 49,152 x 2,048 x 4,096

--cards 4: sharded `search` over four cards against one card, and one
~68 Mbp genome (>= 512 chunks) through `sketch`, which shards it over the
cards (sequence parallelism), against the single-card tiled path.

Any failed check raises. Without a GPU, or in a directory without the
rest of the repository, the script exits non-zero and prints no result.
The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

SEED = 2024
N_GENOMES = 32
GENOME_BP = (1_000_000, 6_000_000)
FAMILY_RATES = (0.01, 0.02, 0.04)  # genomes 1..3 mutate genome 0
N_CPU_SKETCH = 4                   # genomes 0..3 (the family)
ORACLE_BP = 300_000
DB_ROWS = 49_152
TOP_K = 10
PROD_BATCH, PROD_CHUNKS = 8, 32    # 8 x 4.19 Mbp production bucket
DOT_M, DOT_N = 49_152, 2_048
SEQPAR_BP = 68_000_000             # 519 chunks -> bucket 1024 >= 512
TIMING_REPS = 5
E2E_PAIRS = 10
CHUNK = 1 << 17                    # Sketcher's production chunk_positions
DEVICE = "gpu"                     # the CLI's -D for every command here

_ACGT = np.frombuffer(b"ACGT", np.uint8)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def phase(name):
    print(f"[{name}] start", flush=True)
    t = time.perf_counter()
    yield
    print(f"[{name}] ok in {time.perf_counter() - t:.1f} s", flush=True)


def cli(*args):
    from hypergen_tpu.cli import main

    main([str(a) for a in args])


# -- data --------------------------------------------------------------------


def _write_fasta(path, contigs, width=80):
    """contigs: list of uint8 ASCII arrays; lines wrapped at `width`."""
    with open(path, "wb") as fh:
        for j, seq in enumerate(contigs):
            fh.write(b">%s_c%d\n" % (path.stem.encode(), j))
            n = seq.size // width * width
            body = np.concatenate(
                [seq[:n].reshape(-1, width),
                 np.full((n // width, 1), ord("\n"), np.uint8)], axis=1,
            )
            fh.write(body.tobytes())
            if seq.size > n:
                fh.write(seq[n:].tobytes() + b"\n")


def _genome(rng, bp, n_contigs, base=None, rate=0.0):
    """ASCII genome: random (or `base` mutated at `rate`), N runs, split
    into contigs."""
    if base is None:
        codes = rng.integers(0, 4, bp, dtype=np.uint8)
    else:
        codes = base.copy()
        hit = rng.random(codes.size) < rate
        codes[hit] = (codes[hit] + rng.integers(1, 4, int(hit.sum()),
                                                dtype=np.uint8)) % 4
    seq = _ACGT[codes]
    for _ in range(int(rng.integers(3, 20))):  # assembly gaps
        s = int(rng.integers(0, seq.size - 600))
        seq[s : s + int(rng.integers(1, 500))] = ord("N")
    cuts = np.sort(rng.choice(np.arange(1000, seq.size - 1000),
                              n_contigs - 1, replace=False))
    return codes, np.split(seq, cuts)


def make_genomes(d: Path, rng):
    d.mkdir(parents=True)
    lengths = rng.integers(*GENOME_BP, N_GENOMES)
    paths, base = [], None
    for i in range(N_GENOMES):
        p = d / f"g{i:02d}.fna"
        if 1 <= i <= len(FAMILY_RATES):
            _, contigs = _genome(rng, 0, 3, base=base,
                                 rate=FAMILY_RATES[i - 1])
        else:
            codes, contigs = _genome(rng, int(lengths[i]),
                                     int(rng.integers(1, 6)))
            if i == 0:
                base = codes
        _write_fasta(p, contigs)
        paths.append(p)
    return paths


# -- phases --------------------------------------------------------------------


def card_phase():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (platform {devs[0].platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi)
    print(f"jax {jax.__version__}; XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"devices: {len(devs)} x {devs[0].device_kind}")
    from hypergen_tpu.io.fastx import _native_packed_reader

    print("FASTA parser:", "native (built from native/fastx.cpp)"
          if _native_packed_reader() else "numpy (native build unavailable)")
    return smi.splitlines()[0], devs


def sketch_phase(work, gdir):
    from hypergen_tpu.models.sketcher import Sketcher, packed_row_words
    from hypergen_tpu.params import SketchParams

    cli("sketch", "-p", gdir, "-o", work / "db.sketch", "-D", DEVICE)
    cli("sketch", "-p", gdir, "-o", work / "db.hgdb", "-D", DEVICE)
    from hypergen_tpu.io.sketch_db import load_sharded_db, load_sketch

    sk = load_sketch(work / "db.sketch")
    db = load_sharded_db(work / "db.hgdb")
    check(len(sk) == N_GENOMES and len(db.names) == N_GENOMES,
          "sketch count")
    for s, hv in zip(sk, db.hvs):
        check(np.array_equal(np.asarray(s.decompress(), np.int16), hv),
              f"{s.file_str}: .sketch and .hgdb HVs differ")
    check(all(s.hv_norm_2 > 0 for s in sk), "empty sketch")
    # memory of the production step as compiled for the card
    from hypergen_tpu.backend import caps

    check(caps().hash_path == "packed", "packed kernel not chosen")
    sker = Sketcher(SketchParams(), batch=PROD_BATCH, chunk_positions=CHUNK,
                    packed=True)
    step, *_ = sker._get_step(PROD_CHUNKS, validity="packed")
    W = packed_row_words(PROD_CHUNKS, sker.C)
    import jax

    shapes = (
        jax.ShapeDtypeStruct((PROD_BATCH, W), np.uint32),
        jax.ShapeDtypeStruct((PROD_BATCH, sker.run_cap, 2), np.int32),
        jax.ShapeDtypeStruct((PROD_BATCH,), np.int32),
    )
    print("production step memory:",
          step.lower(*shapes).compile().memory_analysis())
    return sk, db


def dist_phase(work):
    sk = work / "db.sketch"
    cli("dist", "-r", sk, "-q", sk, "-o", work / "d80.tsv", "-a", 80,
        "-D", DEVICE)
    cli("dist", "-r", sk, "-q", sk, "-o", work / "d30.tsv", "-a", 30,
        "-D", DEVICE)
    d80 = (work / "d80.tsv").read_text().splitlines(keepends=True)
    d30 = (work / "d30.tsv").read_text().splitlines(keepends=True)
    check(len(d80) > 0 and len(d30) > len(d80), "dist row counts")
    check(d30[: len(d80)] == d80,
          "-a 80 rows differ from the leading -a 30 rows")
    check(float(d30[len(d80)].split("\t")[2]) <= 80.0,
          "-a 80 dropped a row at or above 80")
    print(f"dist rows: {len(d80)} at -a 80, {len(d30)} at -a 30 "
          f"of {N_GENOMES * (N_GENOMES - 1) // 2} pairs")


def build_db(sk_hvs, names, rng):
    """DB_ROWS rows: copy c of every query gets the same +-1 steps at
    40*(c+1) random positions, so the copies of a query rank by c with
    clear gaps at the top."""
    n_src, D = sk_hvs.shape
    rows = DB_ROWS // n_src
    hv = np.repeat(sk_hvs.astype(np.int32)[:, None, :], rows, axis=1)
    for c in range(rows):
        v = rng.integers(0, 2 * D, 40 * (c + 1))
        hv[:, c] += np.bincount(v >> 1, weights=1 - 2 * (v & 1),
                                minlength=D).astype(np.int32)
    hv = hv.reshape(-1, D).astype(np.int16)
    norms = np.sum(hv.astype(np.int64) ** 2, axis=1).astype(np.int32)
    db_names = [f"{names[s]}~{c:04d}" for s in range(n_src)
                for c in range(rows)]
    return hv, norms, db_names


def write_db(path, hv, norms, db_names, n_shards=4):
    from hypergen_tpu.io.sketch_db import ShardedDB, dump_sharded_db

    dump_sharded_db(ShardedDB(
        ksize=21, scaled=1500, canonical=True, seed=123, hv_d=hv.shape[1],
        names=db_names, hvs=hv, norms=norms,
    ), path, n_shards=n_shards)


def expected_search_tsv(path, db_hv, db_norms, db_names, q_hv, q_norms,
                        q_names):
    """Top-10 TSV from exact host dots (float64 products of int16 HVs are
    exact: |sum| < 2^53) and the host float32 ANI chain."""
    from hypergen_tpu.models.comparator import ani_f32_host, write_search_report

    dots = q_hv.astype(np.float64) @ db_hv.astype(np.float64).T
    dots = dots.astype(np.int64).astype(np.int32)  # the reference's i32 wrap
    ani = ani_f32_host(dots.T, db_norms, q_norms, 21).T  # [N, M]
    # rank by host ANI, ties to the lower DB row (lax.top_k's order)
    order = np.argsort(-ani, axis=1, kind="stable")[:, :TOP_K]
    write_search_report(
        path, db_names, q_names, order, np.take_along_axis(ani, order, 1),
        0.0,
    )
    return ani


def search_phase(work, sk, rng):
    from hypergen_tpu.io.sketch_db import sketches_to_db

    q = sketches_to_db(sk)
    hv, norms, names = build_db(q.hvs, q.names, rng)
    write_db(work / "big.hgdb", hv, norms, names)
    cli("search", "-r", work / "big.hgdb", "-q", work / "db.sketch",
        "-o", work / "hits.tsv", "-a", 0, "--top_k", TOP_K, "-D", DEVICE)
    expected_search_tsv(work / "want.tsv", hv, norms, names, q.hvs,
                        q.norms, q.names)
    got = (work / "hits.tsv").read_bytes()
    want = (work / "want.tsv").read_bytes()
    check(got == want, "search hits differ from the exact host dot:\n"
          + _first_diff(got, want))
    print(f"search: {len(got.splitlines())} hits of {N_GENOMES} queries "
          f"x {DB_ROWS} rows equal the exact host dot")


def _first_diff(a: bytes, b: bytes) -> str:
    la, lb = a.decode().splitlines(), b.decode().splitlines()
    for i, (x, y) in enumerate(zip(la, lb)):
        if x != y:
            return f"line {i}: got {x!r}, want {y!r}"
    return f"lengths {len(la)} vs {len(lb)}"


def cpu_child(commands):
    """Run CLI commands in one child process pinned to the CPU backend; it
    never opens the card."""
    code = (
        "import sys; from hypergen_tpu.cli import main\n"
        f"for argv in {commands!r}:\n"
        "    main(argv + ['-D', 'cpu'])\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=900)
    check(r.returncode == 0,
          f"CPU child failed ({r.returncode}):\n{r.stdout[-3000:]}"
          f"\n{r.stderr[-3000:]}")


def _same_files(a: Path, b: Path, what):
    if a.is_dir():
        names = sorted(p.name for p in a.iterdir())
        check(names == sorted(p.name for p in b.iterdir()), f"{what}: files")
        for n in names:
            _same_files(a / n, b / n, f"{what}/{n}")
    else:
        check(a.read_bytes() == b.read_bytes(),
              f"{what}: GPU and CPU bytes differ")


def parity_phase(work, paths, rng):
    from hypergen_tpu.io.fastx import read_fasta_records
    from hypergen_tpu.io.sketch_db import load_sketch
    from hypergen_tpu.oracle import pipeline as orp

    sub = work / "sub"
    sub.mkdir()
    for p in paths[:N_CPU_SKETCH]:
        shutil.copy(p, sub / p.name)
    gpu, cpu = work / "gpu", work / "cpu"
    gpu.mkdir()
    cpu.mkdir()
    sk = work / "db.sketch"
    cli("sketch", "-p", sub, "-o", gpu / "sub.sketch", "-D", DEVICE)
    cli("sketch", "-p", sub, "-o", gpu / "sub.hgdb", "-D", DEVICE)
    cpu_child([
        ["sketch", "-p", str(sub), "-o", str(cpu / "sub.sketch")],
        ["sketch", "-p", str(sub), "-o", str(cpu / "sub.hgdb")],
        ["dist", "-r", str(sk), "-q", str(sk), "-o", str(cpu / "d80.tsv"),
         "-a", "80"],
        ["dist", "-r", str(sk), "-q", str(sk), "-o", str(cpu / "d30.tsv"),
         "-a", "30"],
    ])
    _same_files(gpu / "sub.sketch", cpu / "sub.sketch", "sub.sketch")
    _same_files(gpu / "sub.hgdb", cpu / "sub.hgdb", "sub.hgdb")
    _same_files(work / "d80.tsv", cpu / "d80.tsv", "dist -a 80")
    _same_files(work / "d30.tsv", cpu / "d30.tsv", "dist -a 30")
    print(f"parity: .sketch/.hgdb of {N_CPU_SKETCH} genomes and both dist "
          "TSVs of all 32 byte-identical to the CPU backend")
    # the pure-Python oracle on one short genome
    odir = work / "oracle"
    odir.mkdir()
    _, contigs = _genome(rng, ORACLE_BP, 3)
    _write_fasta(odir / "short.fna", contigs)
    cli("sketch", "-p", odir, "-o", work / "short.sketch", "-D", DEVICE)
    got = load_sketch(work / "short.sketch")[0]
    recs = read_fasta_records(odir / "short.fna")
    want = orp.sketch_genome([r[1] for r in recs])
    check(np.array_equal(np.asarray(got.decompress(), np.int16), want["hv"])
          and got.hv_norm_2 == want["norm2"],
          "GPU sketch differs from the oracle")
    print(f"oracle: {ORACLE_BP} bp genome, {len(want['hashes'])} hashes, "
          "HV and norm equal")


def _alternate(fns, reps=TIMING_REPS):
    """Per-call seconds of each fn, timed in A B .. B A order after a
    warm-up call each."""
    import jax

    for f in fns:
        jax.block_until_ready(f())
    times = [[] for _ in fns]
    for order in (range(len(fns)), reversed(range(len(fns)))):
        for i in order:
            for _ in range(reps):
                t = time.perf_counter()
                jax.block_until_ready(fns[i]())
                times[i].append(time.perf_counter() - t)
    return times


def _fmt(ts):
    return (f"median {np.median(ts) * 1e3:.3f} ms "
            f"(min {min(ts) * 1e3:.3f}, max {max(ts) * 1e3:.3f}, n={len(ts)})")


def decide_phase(card, paths, rng):
    import jax
    import jax.numpy as jnp

    from hypergen_tpu.io.fastx import packed_from_codes
    from hypergen_tpu.models.sketcher import Sketcher, split_step_output
    from hypergen_tpu.params import SketchParams

    sp = SketchParams()
    L = PROD_CHUNKS * CHUNK + sp.ksize - 1 - 20
    genomes = []
    for _ in range(PROD_BATCH):
        codes = rng.integers(0, 4, L, dtype=np.uint8)
        for _ in range(10):
            s = int(rng.integers(0, L - 600))
            codes[s : s + int(rng.integers(1, 500))] = 4
        genomes.append(packed_from_codes(codes))
    steps = {}
    for name, packed in (("kernel", True), ("xla", False)):
        sk = Sketcher(sp, batch=PROD_BATCH, chunk_positions=CHUNK,
                      packed=packed)
        mode, *args = sk._prepare_batch(genomes, PROD_CHUNKS)
        check(mode == ("packed" if packed else "runs"), f"{name}: {mode}")
        step, *_ = sk._get_step(PROD_CHUNKS, validity=mode)
        dargs = [jnp.asarray(a) for a in args]
        steps[name] = (lambda s=step, a=dargs: s(*a))
    # HVs, norms and hash counts (meta columns 2-4 are path-specific
    # capacity counters)
    out = {n: split_step_output(np.asarray(f())) for n, f in steps.items()}
    check(np.array_equal(out["kernel"][0], out["xla"][0])
          and np.array_equal(out["kernel"][1][:, :2], out["xla"][1][:, :2]),
          "kernel and XLA steps differ at the production bucket")
    tk, tx = _alternate([steps["kernel"], steps["xla"]])
    mbp = PROD_BATCH * PROD_CHUNKS * CHUNK / 1e6
    print(f"[{card}] step {PROD_BATCH}x{PROD_CHUNKS}x{CHUNK} ({mbp:.0f} Mbp): "
          f"kernel {_fmt(tk)}; xla {_fmt(tx)}; "
          f"kernel/xla {np.median(tk) / np.median(tx):.3f}")
    # end to end through sketch_files on the same 32 genome files
    e2e = {}
    sketchers = {n: Sketcher(sp, packed=(n == "kernel"))
                 for n in ("kernel", "xla")}
    res = {n: s.sketch_files(paths, progress=False)  # warm: compiles
           for n, s in sketchers.items()}
    for a, b in zip(res["kernel"], res["xla"]):
        check(np.array_equal(a.hv, b.hv) and a.hv_norm_2 == b.hv_norm_2
              and a.hv_quant_bits == b.hv_quant_bits,
              f"{a.file_str}: kernel and XLA sketches differ")
    wins = 0
    for i in range(E2E_PAIRS):  # pairs, alternating which side runs first
        pair = ("kernel", "xla") if i % 2 == 0 else ("xla", "kernel")
        for n in pair:
            t = time.perf_counter()
            sketchers[n].sketch_files(paths, progress=False)
            e2e.setdefault(n, []).append(time.perf_counter() - t)
        wins += e2e["kernel"][-1] < e2e["xla"][-1]
    bp = sum(p.stat().st_size for p in paths) / 1e6
    print(f"[{card}] sketch_files {len(paths)} genomes (~{bp:.0f} MB FASTA), "
          f"{E2E_PAIRS} pairs, kernel faster in {wins}: "
          + "; ".join(f"{n} median {np.median(v):.4f} s "
                      f"(quartiles {np.percentile(v, 25):.4f}-"
                      f"{np.percentile(v, 75):.4f}), "
                      f"{len(paths) / np.median(v):.1f} genomes/s"
                      for n, v in e2e.items()))
    dot_phase(card, rng)


def dot_phase(card, rng):
    import jax
    import jax.numpy as jnp

    from hypergen_tpu.ops.ani import dot_i16_exact

    D = 4096
    base = rng.integers(-120, 121, (64, D)).astype(np.int16)
    r = jnp.asarray(np.repeat(base, DOT_M // 64, axis=0)
                    + rng.integers(-3, 4, (DOT_M, D)).astype(np.int16))
    q = jnp.asarray(r[:DOT_N] + 1)
    modes = {"int32": False, "int8x4": True, "int8x3": "small"}
    fns, outs = [], []
    for name, mode in modes.items():
        f = jax.jit(lambda a, b, m=mode: dot_i16_exact(a, b, int8_split=m))
        hlo = f.lower(r, q).compile().as_text()
        # the matrix products as XLA compiled them: library GEMM custom
        # calls, Triton GEMM fusions or plain dots
        gemm = [ln.strip() for ln in hlo.splitlines()
                if any(t in ln for t in ("custom_call_target=", "dot(",
                                         "triton_gemm"))]
        s8 = [ln for ln in gemm if "s8[" in ln]
        print(f"dot {name}: {len(gemm)} GEMM lines, {len(s8)} with s8")
        for ln in gemm[:6]:
            print(f"    {ln[:220]}")
        if mode is not False:
            check(s8, f"{name}: no int8 GEMM in the compiled HLO")
        fns.append(lambda f=f: f(r, q))
        outs.append(fns[-1]())
    check(all(bool(jnp.array_equal(outs[0], o)) for o in outs[1:]),
          "dot modes disagree")
    times = _alternate(fns)
    for (name, mode), ts in zip(modes.items(), times):
        n_mm = {False: 1, True: 4, "small": 3}[mode]
        t = float(np.median(ts))
        print(f"[{card}] dot {name} {DOT_M}x{DOT_N}x{D}: {_fmt(ts)}, "
              f"{DOT_M * DOT_N / t / 1e9:.1f} Gpairs/s, "
              f"{n_mm * 2 * DOT_M * DOT_N * D / t / 1e12:.1f} TOP/s "
              f"({n_mm} matmul(s))")
    _trace_dots(fns, list(modes))


def _trace_dots(fns, names):
    """Profile one call of each dot mode; print the device kernels that
    take the time (the int8 modes should show tensor-core int8 GEMMs)."""
    import jax

    tdir = tempfile.mkdtemp(prefix="hg_trace_")
    with jax.profiler.trace(tdir):
        for f in fns:
            jax.block_until_ready(f())
    from jax.profiler import ProfileData

    xplane = next(Path(tdir).rglob("*.xplane.pb"))
    prof = ProfileData.from_file(str(xplane))
    kern = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                kern[ev.name] = kern.get(ev.name, 0.0) + ev.duration_ns
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    check(top, "no device events in the trace")
    print(f"trace of {names}: top device kernels")
    for n, ns in top:
        print(f"  {ns / 1e6:9.3f} ms  {n[:110]}")
    shutil.rmtree(tdir)


# -- four cards ----------------------------------------------------------------


def cards4_phase(work, rng):
    import jax

    from hypergen_tpu.io.fastx import read_genome_packed
    from hypergen_tpu.io.sketch_db import load_sharded_db, load_sketch
    from hypergen_tpu.models.sketcher import Sketcher
    from hypergen_tpu.params import SketchParams
    from hypergen_tpu.parallel.mesh import make_mesh
    from hypergen_tpu.parallel.search import sharded_topk_search

    devs = jax.devices()
    check(len(devs) == 4, f"--cards 4 needs 4 GPUs, JAX has {len(devs)}")
    # sharded search: queries are seeded HVs of sketch magnitude
    with phase("search x4"):
        qhv = rng.integers(-90, 91, (N_GENOMES, 4096)).astype(np.int16)
        qn = np.sum(qhv.astype(np.int64) ** 2, axis=1).astype(np.int32)
        qnames = [f"q{i:02d}" for i in range(N_GENOMES)]
        hv, norms, names = build_db(qhv, qnames, rng)
        write_db(work / "big.hgdb", hv, norms, names)
        write_db(work / "q.hgdb", qhv, qn, qnames, n_shards=1)
        cli("search", "-r", work / "big.hgdb", "-q", work / "q.hgdb",
            "-o", work / "hits4.tsv", "-a", 0, "--top_k", TOP_K,
            "-D", DEVICE)
        expected_search_tsv(work / "want.tsv", hv, norms, names, qhv, qn,
                            qnames)
        got = (work / "hits4.tsv").read_bytes()
        want = (work / "want.tsv").read_bytes()
        check(got == want, "4-card search differs from the exact host dot:\n"
              + _first_diff(got, want))
        one = sharded_topk_search(make_mesh(devices=devs[:1]), hv, norms,
                                  qhv, qn, ksize=21, k_top=TOP_K)
        four = sharded_topk_search(make_mesh(devices=devs), hv, norms,
                                   qhv, qn, ksize=21, k_top=TOP_K)
        for a, b, what in zip(one, four, ("ani", "idx", "dot")):
            check(np.array_equal(a, b), f"search {what}: 4 cards != 1 card")
        print("search: 4-card mesh == 1 card, hits == exact host dot")
    with phase("seqpar x4"):
        gdir = work / "huge"
        gdir.mkdir()
        _, contigs = _genome(rng, SEQPAR_BP, 4)
        _write_fasta(gdir / "huge.fna", contigs)
        cli("sketch", "-p", gdir, "-o", work / "huge.sketch", "-D", DEVICE)
        got = load_sketch(work / "huge.sketch")[0]
        sk = Sketcher(SketchParams())
        check(sk._bucket(read_genome_packed(gdir / "huge.fna").length)
              >= sk.seqpar_min_chunks, "genome below the seqpar bucket")
        want = sk.sketch_packed_tiled(read_genome_packed(gdir / "huge.fna"),
                                      tile_chunks=sk.seqpar_min_chunks // 8)
        check(np.array_equal(np.asarray(got.decompress(), np.int16),
                             want["hv"])
              and got.hv_norm_2 == want["norm2"],
              "4-card seqpar sketch != single-card tiled sketch")
        print(f"seqpar: {SEQPAR_BP} bp over 4 cards == 1-card tiled, "
              f"{want['n_hashes']} hashes")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the paths that span four cards")
    args = ap.parse_args(argv)
    import jax

    from hypergen_tpu.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    with phase("card"):
        card, devs = card_phase()
    rng = np.random.default_rng(SEED)
    work = Path(tempfile.mkdtemp(prefix="hg_smoke_"))
    try:
        if args.cards == 4:
            cards4_phase(work, rng)
        else:
            with phase("data"):
                paths = make_genomes(work / "genomes", rng)
                print(f"{len(paths)} genomes, "
                      f"{sum(p.stat().st_size for p in paths) / 1e6:.1f} MB")
            with phase("sketch"):
                sk, _ = sketch_phase(work, work / "genomes")
            with phase("dist"):
                dist_phase(work)
            with phase("search"):
                search_phase(work, sk, rng)
            with phase("parity"):
                parity_phase(work, paths, rng)
            with phase("decide"):
                decide_phase(card, paths, rng)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs),
    }}))


if __name__ == "__main__":
    main()
