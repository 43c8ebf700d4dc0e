"""Benchmark harness: genomes sketched/s + ANI pairs/s on one GPU.

Prints ONE JSON line (last line of output):
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "extra": {...}}

Workload (BASELINE.json operating point): k=21, scaled=1500, D=4096.

The headline sketch number is the full production path measured end to
end on FASTA files on disk: native fused parse -> packed 2-bit codes + run
list -> H2D -> device hash/dedup/encode -> fused D2H, median of 3 runs over
distinct file sets, with a per-stage wall breakdown. Two realism variants
accompany it: mixed-length GC-biased genomes with N runs (exercises
bucketing and the run postfilter) and D=8192. ANI is measured in the
production shapes: resident-DB top-k search, full-table dist, and
thresholded dist.

vs_baseline: the reference publishes no absolute numbers (BASELINE.md);
we normalize against REF_EST_GENOMES_PER_SEC = 50.0, an order-of-magnitude
estimate of the reference CLI on a 16-thread CPU for 4-Mbp genomes.

The harness measures the GPU only: without one it exits non-zero and
prints no result.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REF_EST_GENOMES_PER_SEC = 50.0

SIZES = dict(
    genome_bp=4_000_000, n_files=32, batch=16, collect_group=8,
    n_files_mixed=16, mixed_batch=8, n_files_d8192=8,
    mixed_bp_range=(1e6, 4e6),
    ani_db=49152, ani_queries=2048, ani_repeats=3, ani_table_db=4096,
)

ANI_TOPK = 10
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _write_fasta(path: Path, seq: np.ndarray) -> None:
    path.write_bytes(b">g\n" + seq.tobytes() + b"\n")


def _gen_uniform(d: Path, n: int, bp: int, seed0: int) -> list:
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n):
        r = np.random.default_rng(seed0 + i)
        _write_fasta(d / f"g{i:03d}.fna", r.choice(_BASES, size=bp))
        paths.append(d / f"g{i:03d}.fna")
    return paths


def _gen_mixed(d: Path, n: int, seed0: int, bp_range) -> list:
    """Mixed lengths (log-uniform), GC bias, sprinkled N runs."""
    d.mkdir(parents=True, exist_ok=True)
    paths = []
    total_bp = 0
    lo, hi = bp_range
    for i in range(n):
        # lengths from a FIXED stream so warm/timed sets share jit buckets
        bp = int(np.exp(
            np.random.default_rng(555 + i).uniform(np.log(lo), np.log(hi))
        ))
        r = np.random.default_rng(seed0 + i)
        gc = 0.35 if i % 2 else 0.65
        probs = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        seq = r.choice(_BASES, size=bp, p=probs)
        for _ in range(int(r.integers(2, 30))):  # N runs (assembly gaps)
            s = int(r.integers(0, bp - 500))
            seq[s : s + int(r.integers(5, 400))] = ord("N")
        _write_fasta(d / f"m{i:03d}.fna", seq)
        paths.append(d / f"m{i:03d}.fna")
        total_bp += bp
    return paths, total_bp


def _sketch_rate(paths, params, batch, warm_paths=None, group=None):
    """(genomes/s, wall, stage_times, h2d_bytes).

    warm_paths (same length buckets, different content) are sketched first
    untimed to absorb compiles; pass [] to skip warming."""
    from hypergen_tpu.models.sketcher import Sketcher

    kw = {"collect_group": group} if group else {}
    sk = Sketcher(params, batch=batch, **kw)
    warm = warm_paths if warm_paths is not None else paths[:2]
    if warm:
        sk.sketch_files(warm, progress=False)
    t0 = time.monotonic()
    out = sk.sketch_files(paths, progress=False)
    dt = time.monotonic() - t0
    assert len(out) == len(paths)
    return len(paths) / dt, dt, dict(sk.last_stage_times), sk.last_h2d_bytes


def bench_sketch(tmp: Path, sizes: dict):
    from hypergen_tpu.params import SketchParams

    res = {}
    # headline: uniform genomes, default params, median of 3 runs over
    # distinct file sets; warm with 2 batches worth of files so the
    # fused-concat program shape compiles outside the timed region
    uwarm = _gen_uniform(
        tmp / "uniform_warm", 2 * sizes["batch"], sizes["genome_bp"], 700
    )
    reps = []
    for rep in range(3):
        paths = _gen_uniform(
            tmp / f"uniform{rep}", sizes["n_files"], sizes["genome_bp"],
            100 + 1000 * rep,
        )
        reps.append(_sketch_rate(
            paths, SketchParams(), batch=sizes["batch"],
            warm_paths=uwarm if rep == 0 else [],
            group=sizes.get("collect_group"),
        ))
    reps_rates = [r for r, *_ in reps]
    mid = int(np.argsort(reps_rates)[len(reps_rates) // 2])
    rate, dt, stages, h2d = reps[mid]
    total = sum(stages.values()) or 1.0
    res["genomes_per_sec"] = rate
    res["genomes_per_sec_reps"] = [round(r, 3) for r in reps_rates]
    res["genome_bp"] = sizes["genome_bp"]
    res["bp_per_sec"] = rate * sizes["genome_bp"]
    res["sketch_wall_s"] = dt
    res["stage_shares"] = {
        k: round(v / total, 3) for k, v in sorted(stages.items())
    }
    res["h2d_mbytes"] = round(h2d / 1e6, 1)
    # realism: mixed lengths + GC bias + N runs (BASELINE config 3); the
    # warm set shares the length profile (same jit buckets)
    wpaths, _ = _gen_mixed(
        tmp / "mixed_warm", sizes["n_files_mixed"], 900,
        sizes["mixed_bp_range"],
    )
    mpaths, mixed_bp = _gen_mixed(
        tmp / "mixed", sizes["n_files_mixed"], 1900, sizes["mixed_bp_range"]
    )
    mrate, mdt, _, _ = _sketch_rate(
        mpaths, SketchParams(), batch=sizes["mixed_batch"], warm_paths=wpaths
    )
    res["genomes_per_sec_mixed"] = mrate
    res["bp_per_sec_mixed"] = mixed_bp / mdt
    # D=8192
    n8 = sizes["n_files_d8192"]
    drate, _, _, _ = _sketch_rate(
        paths[:n8], SketchParams(hv_d=8192), batch=sizes["mixed_batch"],
        warm_paths=paths[n8 : n8 + 2],
    )
    res["genomes_per_sec_d8192"] = drate
    return res


def bench_ani(sizes: dict):
    import jax
    import jax.numpy as jnp

    from hypergen_tpu.io.sketch_db import ShardedDB
    from hypergen_tpu.models.comparator import Comparator, ani_f32_host
    from hypergen_tpu.ops.ani import (
        SMALL_SPLIT_MAX, abs_bound, ani_topk, presplit_rows,
        presplit_rows_small,
    )

    ANI_DB = sizes["ani_db"]
    ANI_QUERIES = sizes["ani_queries"]
    ANI_REPEATS = sizes["ani_repeats"]
    ANI_TABLE_DB = sizes["ani_table_db"]

    rng = np.random.default_rng(1)
    db = rng.integers(-80, 80, size=(ANI_DB, 4096)).astype(np.int16)
    dbn = np.sum(db.astype(np.int64) ** 2, axis=1).astype(np.int32)

    def fresh_q():
        q = rng.integers(-80, 80, size=(ANI_QUERIES, 4096)).astype(np.int16)
        qn = np.sum(q.astype(np.int64) ** 2, axis=1).astype(np.int32)
        return q, qn

    # search mode: DB resident as pre-split int8 planes (SmallSplit when
    # the values fit, like Comparator.preload_rows), top-k on device
    small = abs_bound(db) <= SMALL_SPLIT_MAX  # queries share the range
    mode = "small" if small else True
    splitter = presplit_rows_small if small else presplit_rows
    db_dev = jax.jit(splitter)(jax.device_put(db))
    dbn_dev = jax.device_put(dbn)
    q0, qn0 = fresh_q()
    jax.device_get(
        ani_topk(db_dev, dbn_dev, jnp.asarray(q0), jnp.asarray(qn0), 21,
                 ANI_TOPK, int8_split=mode)
    )
    queries = [fresh_q() for _ in range(ANI_REPEATS)]
    t0 = time.monotonic()
    for q, qn in queries:
        jax.device_get(ani_topk(
            db_dev, dbn_dev, jnp.asarray(q), jnp.asarray(qn), 21, ANI_TOPK,
            int8_split=mode,
        ))
    dt_search = time.monotonic() - t0
    search_pairs = ANI_DB * ANI_QUERIES * ANI_REPEATS / dt_search

    # table mode: full dot tiles D2H + host float map (dist TSV path)
    tdb, tdbn = db[:ANI_TABLE_DB], dbn[:ANI_TABLE_DB]
    comp = Comparator(ksize=21, tile_m=ANI_TABLE_DB, tile_n=ANI_QUERIES)
    db_blocks = comp.preload_rows(tdb)
    q0, qn0 = fresh_q()
    for mi, nj, tile in comp.dot_tiles(tdb, q0, r_blocks=db_blocks):
        ani_f32_host(tile, tdbn[mi : mi + tile.shape[0]],
                     qn0[nj : nj + tile.shape[1]], 21)
    t0 = time.monotonic()
    for q, qn in queries:
        for mi, nj, tile in comp.dot_tiles(tdb, q, r_blocks=db_blocks):
            ani_f32_host(tile, tdbn[mi : mi + tile.shape[0]],
                         qn[nj : nj + tile.shape[1]], 21)
    dt_table = time.monotonic() - t0
    table_pairs = ANI_TABLE_DB * ANI_QUERIES * ANI_REPEATS / dt_table

    # dist mode at the production threshold: device filter+compact,
    # survivors only cross D2H (the `dist -a 85` path)
    def as_db(hv, norms):
        return ShardedDB(
            ksize=21, scaled=1500, canonical=True, seed=123,
            hv_d=hv.shape[1], names=[str(i) for i in range(hv.shape[0])],
            hvs=hv, norms=norms,
        )

    ref_db = as_db(db, dbn)
    ref_blocks = comp.preload_ref(ref_db)
    q0, qn0 = fresh_q()
    comp.ani_pairs_thresholded(
        ref_db, as_db(q0, qn0), symmetric=False, threshold=85.0,
        ref_blocks=ref_blocks,
    )
    t0 = time.monotonic()
    for q, qn in queries:
        comp.ani_pairs_thresholded(
            ref_db, as_db(q, qn), symmetric=False, threshold=85.0,
            ref_blocks=ref_blocks,
        )
    dt_dist = time.monotonic() - t0
    dist_pairs = ANI_DB * ANI_QUERIES * ANI_REPEATS / dt_dist
    return {
        "search_pairs_per_sec": search_pairs,
        "table_pairs_per_sec": table_pairs,
        "dist85_pairs_per_sec": dist_pairs,
    }


def main():
    import jax

    from hypergen_tpu.utils.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    extra = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }
    with tempfile.TemporaryDirectory(prefix="hgbench_") as td:
        sk = bench_sketch(Path(td), SIZES)
    an = bench_ani(SIZES)
    bp_label = f"{SIZES['genome_bp'] / 1e6:g}Mbp"
    extra.update({
        "bp_per_sec": round(sk["bp_per_sec"], 0),
        "genomes_per_sec_reps": sk["genomes_per_sec_reps"],
        "stage_shares": sk["stage_shares"],
        "h2d_mbytes": sk["h2d_mbytes"],
        "genomes_per_sec_mixed": round(sk["genomes_per_sec_mixed"], 3),
        "bp_per_sec_mixed": round(sk["bp_per_sec_mixed"], 0),
        "genomes_per_sec_d8192": round(sk["genomes_per_sec_d8192"], 3),
        "ani_search_pairs_per_sec": round(an["search_pairs_per_sec"], 0),
        "ani_table_pairs_per_sec": round(an["table_pairs_per_sec"], 0),
        "ani_dist85_pairs_per_sec": round(an["dist85_pairs_per_sec"], 0),
        "ani_db_rows": SIZES["ani_db"],
    })
    print(json.dumps({
        "metric": f"genomes sketched/s/GPU ({bp_label}, k=21, s=1500, "
                  "D=4096, files on disk end-to-end, median of 3)",
        "value": round(sk["genomes_per_sec"], 3),
        "unit": "genomes/s",
        "vs_baseline": round(
            sk["bp_per_sec"] / 4.0e6 / REF_EST_GENOMES_PER_SEC, 3
        ),
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
