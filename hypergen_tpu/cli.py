"""hypergen CLI: sketch / dist / search.

Flag surface mirrors the reference CLI (reference:src/utils.rs:16-206):
  sketch -p DIR -o OUT [-k 21 -s 1500 -d 4096 -S 123 -m t1ha2 -C true ...]
  dist   -r REF.sketch -q QUERY.sketch -o OUT.tsv [-a 85.0 ...]
  search -r REF.sketch -q QUERY.sketch -o OUT.tsv [--top_k N]

`search` — an empty TODO stub in the reference (reference:src/main.rs:22-24)
— is implemented here as dist-with-top-k per query.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from pathlib import Path

import numpy as np

from hypergen_tpu import params as P
from hypergen_tpu.params import DistParams, SketchParams
from hypergen_tpu.utils.logging import setup_logging

log = logging.getLogger("hypergen")

# minimum ANI threshold at which `dist` uses the device-side filter+compact
# path (below it, survivor density makes the dense full-table path cheaper)
THRESHOLDED_DIST_MIN = 50.0


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"expected bool, got {v!r}")


def _add_common(sp: argparse.ArgumentParser) -> None:
    sp.add_argument("-t", "--thread", type=int, default=16,
                    help="# of host worker threads for file I/O")
    sp.add_argument("-C", "--canonical", type=_str2bool, default=True,
                    help="use canonical k-mers")
    sp.add_argument("-k", "--ksize", type=int, default=21, help="k-mer size")
    sp.add_argument("-S", "--seed", type=int, default=123, help="hash seed")
    sp.add_argument("-s", "--scaled", type=int, default=1500,
                    help="FracMinHash scaled factor")
    sp.add_argument("-d", "--hv_d", type=int, default=4096,
                    help="hypervector dimension")
    sp.add_argument("-Q", "--quant_scale", type=float, default=1.0,
                    help="HV quantization scale (parsed for compatibility; "
                         "unused, as in the reference)")
    sp.add_argument("-a", "--ani_th", type=float, default=85.0,
                    help="ANI report threshold")
    sp.add_argument("-D", "--device", type=str, default=None,
                    choices=["gpu", "cpu"],
                    help="device backend: 'gpu' requires a CUDA device and "
                         "exits non-zero without one; 'cpu' forces the JAX "
                         "CPU backend; unset keeps JAX's default platform")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="hypergen",
        description=(
            "HyperGen: fast, memory-efficient genome sketching in "
            "hyperdimensional space on accelerators.\n"
            "1. sketch: FracMinHash + HDC sketching of .fna/.fa/.fasta\n"
            "2. dist:   ANI estimation between sketch databases\n"
            "3. search: top-k database search"
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--version", action="version", version=P.VERSION)
    sub = ap.add_subparsers(dest="mode", required=True)

    sk = sub.add_parser(P.CMD_SKETCH, help="sketch genome FASTA files")
    sk.add_argument("-p", "--path", type=Path, required=True,
                    help="input folder to sketch")
    # the reference's sketch subcommand parses -r/-q too (unused there,
    # reference:src/utils.rs:48-53); accept them so scripts port verbatim
    sk.add_argument("-r", "--path_r", type=Path, default=None,
                    help="(compat) unused in sketch mode")
    sk.add_argument("-q", "--path_q", type=Path, default=None,
                    help="(compat) unused in sketch mode")
    sk.add_argument("-o", "--out", type=Path, required=True,
                    help="output sketch file (.sketch) or DB dir (.hgdb)")
    sk.add_argument("-m", "--sketch_method", type=str, default="t1ha2",
                    choices=["t1ha2", "mmhash"])
    sk.add_argument("--shards", type=int, default=1,
                    help="number of shards when writing an .hgdb directory")
    sk.add_argument("--resume", action="store_true",
                    help="skip genomes already present in an existing .hgdb "
                         "output (crash/preemption recovery; the reference's "
                         "all-or-nothing .sketch write has no equivalent)")
    _add_common(sk)

    for name, extra in ((P.CMD_DIST, False), (P.CMD_SEARCH, True)):
        dp = sub.add_parser(
            name,
            help="estimate ANI between sketches" if not extra
            else "top-k search of query sketches against a reference DB",
        )
        dp.add_argument("-p", "--path", type=Path, default=None,
                        help="(compat) unused")
        dp.add_argument("-r", "--path_r", type=Path, required=True,
                        help="reference sketch file / .hgdb dir")
        dp.add_argument("-q", "--path_q", type=Path, required=True,
                        help="query sketch file / .hgdb dir")
        dp.add_argument("-o", "--out", type=Path, required=True,
                        help="output ANI TSV")
        dp.add_argument("-m", "--sketch_method", type=str, default="fracminhash")
        if extra:
            dp.add_argument("--top_k", type=int, default=10,
                            help="hits reported per query")
        _add_common(dp)

    hp = sub.add_parser(
        "hist",
        help="print value\\tcount histogram of all HV entries in a sketch "
             "(debug utility, reference:src/utils.rs:312-337)",
    )
    hp.add_argument("-r", "--path_r", type=Path, required=True,
                    help="sketch file to histogram")
    return ap


def _load_db(path: Path):
    from hypergen_tpu.io.sketch_db import load_sharded_db, load_sketch, sketches_to_db

    if path.is_dir():
        return load_sharded_db(path)
    return sketches_to_db(load_sketch(path))


def run_sketch(args) -> None:
    from hypergen_tpu.io.fastx import get_fasta_files
    from hypergen_tpu.io.sketch_db import dump_sharded_db, dump_sketch, sketches_to_db
    from hypergen_tpu.models.sketcher import Sketcher

    sp = SketchParams(
        path=args.path, out_file=args.out, sketch_method=args.sketch_method,
        canonical=args.canonical, device=args.device, ksize=args.ksize,
        seed=args.seed, scaled=args.scaled, hv_d=args.hv_d,
        hv_quant_scale=args.quant_scale, threads=args.thread,
    )
    files = get_fasta_files(sp.path)
    if not files:
        log.error("no FASTA files found under %s", sp.path)
        sys.exit(1)
    is_hgdb = str(args.out).endswith(".hgdb")

    import jax

    if jax.process_count() > 1:
        if not is_hgdb:
            log.error("multi-host sketching requires an .hgdb output")
            sys.exit(1)
        _run_sketch_pod(sp, files, args)
        return
    resuming = False
    if getattr(args, "resume", False) and is_hgdb and (
        Path(args.out) / "manifest.json"
    ).exists():
        import json

        manifest = json.loads((Path(args.out) / "manifest.json").read_text())
        _check_resume_params(manifest, sp)
        files, skipped = _filter_resumed(manifest, files)
        if skipped:
            log.info("Resume: %d of %d genomes already sketched", skipped,
                     skipped + len(files))
        resuming = True
        if not files:
            log.info("Resume: nothing left to sketch")
            return
    log.info("Start sketching...")
    t0 = time.monotonic()
    sketcher = Sketcher(sp)
    sketches = sketcher.sketch_files(files)
    dt = time.monotonic() - t0
    log.info(
        "Sketching %d files took %.2fs - Speed: %.1f files/s",
        len(files), dt, len(files) / dt if dt > 0 else 0.0,
    )
    if is_hgdb:
        db = sketches_to_db(sketches)
        db.sketch_method = sp.sketch_method
        if resuming:
            # append one new shard; existing shard files stay untouched
            from hypergen_tpu.io.sketch_db import append_db_shard

            append_db_shard(args.out, db)
        else:
            dump_sharded_db(db, args.out, n_shards=args.shards)
        log.info("Dump sharded DB to %s", args.out)
    else:
        size = dump_sketch(sketches, args.out)
        log.info(
            "Dump sketch file to %s with size %.2f MB",
            args.out, size / 1024.0 / 1024.0,
        )


def _resolved_set(manifest: dict) -> set:
    """Absolute-path resume keys for an existing manifest.

    Prefers the manifest's recorded resolved_names (absolute paths written
    by the ORIGINAL run in its own cwd) so that resuming from a different
    working directory still matches relative input paths; manifests from
    before the field resolve in the current cwd as a best effort."""
    names = manifest.get("resolved_names") or manifest["names"]
    return {str(Path(n).resolve()) for n in names}


def _check_resume_params(manifest: dict, sp: SketchParams) -> None:
    """--resume must never append rows sketched with different parameters
    (shared by the single-host and pod paths so they can't drift)."""
    if (
        manifest["ksize"], manifest["scaled"], manifest["seed"],
        manifest["hv_d"], manifest["canonical"],
        manifest.get("sketch_method", "t1ha2"),
    ) != (
        sp.ksize, sp.scaled, sp.seed, sp.hv_d,
        sp.canonical, sp.sketch_method,
    ):
        log.error("--resume: existing DB has different sketch params")
        sys.exit(1)


def _filter_resumed(manifest: dict, files) -> tuple:
    """(files not yet in the DB, skipped count) by resolved-path matching:
    keying on the exact string would silently re-sketch (and duplicate DB
    rows) when the resume run spells an input path differently (relative
    vs absolute, trailing slash). Paths resolve once — at GTDB scale the
    resolve() syscalls over hundreds of thousands of files are real time.
    """
    done = _resolved_set(manifest)
    resolved = [str(Path(f).resolve()) for f in files]
    remaining = [f for f, r in zip(files, resolved) if r not in done]
    return remaining, len(files) - len(remaining)


def _run_sketch_pod(sp: SketchParams, files, args) -> None:
    """Pod-mode sketching: host p sketches files[p::nproc] onto its local
    devices and writes one DB shard; process 0 merges the manifest
    (SURVEY 2.3: per-host input file shards). With --resume on an existing
    .hgdb, already-sketched genomes are skipped and the existing shards are
    kept as the merged manifest's prefix."""
    import json

    import jax

    from hypergen_tpu.io.sketch_db import (
        dump_db_shard_part, merge_db_parts, sketches_to_db,
    )
    from hypergen_tpu.models.sketcher import Sketcher
    from hypergen_tpu.parallel.mesh import shared_run_token

    token = shared_run_token()  # guards the merge against stale parts
    pid, nproc = jax.process_index(), jax.process_count()
    base_manifest = None
    shard_offset = 0
    manifest_path = Path(args.out) / "manifest.json"
    if getattr(args, "resume", False) and manifest_path.exists():
        base_manifest = json.loads(manifest_path.read_text())
        _check_resume_params(base_manifest, sp)
        files, skipped = _filter_resumed(base_manifest, files)
        if skipped and pid == 0:
            log.info("Resume: %d of %d genomes already sketched", skipped,
                     skipped + len(files))
        shard_offset = max(
            (sh["id"] + 1 for sh in base_manifest["shards"]), default=0
        )
    mine = files[pid::nproc]
    log.info("Pod sketch: process %d/%d takes %d of %d files",
             pid, nproc, len(mine), len(files))
    t0 = time.monotonic()
    sketches = Sketcher(sp).sketch_files(mine)
    dt = time.monotonic() - t0
    log.info("Sketching %d files took %.2fs - Speed: %.1f files/s",
             len(mine), dt, len(mine) / dt if dt > 0 else 0.0)
    if sketches:
        db = sketches_to_db(sketches)
        db.sketch_method = sp.sketch_method
    else:  # more hosts than files: publish an empty part
        from hypergen_tpu.io.sketch_db import ShardedDB

        db = ShardedDB(
            ksize=sp.ksize, scaled=sp.scaled, canonical=sp.canonical,
            seed=sp.seed, hv_d=sp.hv_d, names=[],
            hvs=np.zeros((0, sp.hv_d), np.int16),
            norms=np.zeros((0,), np.int32),
            sketch_method=sp.sketch_method,
        )
    dump_db_shard_part(
        db, args.out, pid, nproc, token=token, shard_id=shard_offset + pid
    )
    if pid == 0:
        merge_db_parts(args.out, nproc, token=token,
                       base_manifest=base_manifest)
        log.info("Merged %d DB parts into %s", nproc, args.out)


def run_dist(args, top_k: int = 0) -> None:
    """All-pairs dist. top_k (library callers only; the CLI always passes 0)
    is a GLOBAL cap on report rows — NOT the per-query cap of `search`,
    which formats its own per-query reports in parallel.search."""
    from hypergen_tpu.models.comparator import (
        Comparator,
        report_sparsity,
        write_ani_report,
    )

    import jax

    dp = DistParams(
        path_ref_sketch=args.path_r, path_query_sketch=args.path_q,
        out_file=args.out, ksize=args.ksize, hv_d=args.hv_d,
        ani_threshold=args.ani_th, top_k=top_k,
    )
    t0 = time.monotonic()
    if_sym = dp.path_ref_sketch == dp.path_query_sketch
    if jax.process_count() > 1:
        _run_dist_pod(dp, if_sym, t0)
        return
    ref_db = _load_db(dp.path_ref_sketch)
    query_db = ref_db if if_sym else _load_db(dp.path_query_sketch)
    if ref_db.ksize != query_db.ksize:
        log.error("Ref and query sketches use different kmer sizes!")
        sys.exit(1)
    if ref_db.hv_d != query_db.hv_d:
        log.error("Ref and query sketches use different HV dimensions!")
        sys.exit(1)
    log.info("Computing ANI..")
    # ksize comes from the sketch file, not the CLI flag
    # (reference:src/dist.rs:26,50)
    comp = Comparator(ksize=ref_db.ksize)
    if dp.ani_threshold >= THRESHOLDED_DIST_MIN:
        # production thresholds: filter + compact on device, fetch only
        # survivors (tiny D2H); rows are identical to the dense path
        ri, qi, ani, n_total = comp.ani_pairs_thresholded(
            ref_db, query_db, symmetric=if_sym, threshold=dp.ani_threshold
        )
    else:
        # low thresholds: fetch full dot tiles but keep only survivors on
        # host (no M x N matrix materialization)
        ri, qi, ani, n_total = comp.ani_pairs_streamed(
            ref_db, query_db, symmetric=if_sym, threshold=dp.ani_threshold
        )
    n_rep = write_ani_report(
        dp.out_file, ref_db.names, query_db.names, ri, qi, ani,
        dp.ani_threshold, top_k=dp.top_k,
    )
    report_sparsity(n_rep, n_total, dp.ani_threshold)
    log.info(
        "Computed ANIs for %d ref files and %d query files took %.3fs",
        len(ref_db.names), len(query_db.names), time.monotonic() - t0,
    )


def _run_dist_pod(dp: DistParams, if_sym: bool, t0: float) -> None:
    """Pod-mode dist: host p computes pairs for its own ref row range;
    process 0 merges the TSV. An .hgdb ref is row-loaded per host
    (load_db_rows); a legacy .sketch ref is loaded once and row-sliced.
    When the query side is an .hgdb, query rows stream in bounded chunks —
    neither side fully materializes on one host. Thresholds >= 50 use the
    device filter+compact path; lower thresholds the host-filtered streamed
    path. Symmetric runs skip sub-diagonal tiles via global row offsets.
    The merge loads parts one at a time with int32 indices and streams the
    TSV (write_ani_report), so GTDB-scale pair counts stay bounded."""
    import json

    import jax

    from hypergen_tpu.io.sketch_db import load_db_rows
    from hypergen_tpu.models.comparator import (
        Comparator, report_sparsity, write_ani_report,
    )
    from hypergen_tpu.parallel.mesh import shared_run_token

    token = shared_run_token()
    pid, nproc = jax.process_index(), jax.process_count()
    r_is_hgdb = Path(dp.path_ref_sketch).is_dir()
    if r_is_hgdb:
        manifest = json.loads(
            (Path(dp.path_ref_sketch) / "manifest.json").read_text()
        )
        M, r_names, r_ksize, r_hvd = (
            manifest["n_genomes"], manifest["names"],
            manifest["ksize"], manifest["hv_d"],
        )
    else:
        ref_full = _load_db(dp.path_ref_sketch)
        M, r_names, r_ksize, r_hvd = (
            len(ref_full.names), ref_full.names,
            ref_full.ksize, ref_full.hv_d,
        )
    q_is_hgdb = Path(dp.path_query_sketch).is_dir()
    if q_is_hgdb:
        q_manifest = json.loads(
            (Path(dp.path_query_sketch) / "manifest.json").read_text()
        )
        q_names, q_ksize, q_hvd = (
            q_manifest["names"], q_manifest["ksize"], q_manifest["hv_d"],
        )
    else:
        query_full = (
            ref_full if if_sym else _load_db(dp.path_query_sketch)
        )
        q_names, q_ksize, q_hvd = (
            query_full.names, query_full.ksize, query_full.hv_d,
        )
    if r_ksize != q_ksize or r_hvd != q_hvd:
        log.error("Ref and query sketch parameters mismatch!")
        sys.exit(1)
    N = len(q_names)
    lo = round(pid * M / nproc)
    hi = round((pid + 1) * M / nproc)
    ref_part = (
        load_db_rows(dp.path_ref_sketch, lo, hi)
        if r_is_hgdb else _slice_db(ref_full, lo, hi)
    )
    comp = Comparator(ksize=q_ksize)
    thresholded = dp.ani_threshold >= THRESHOLDED_DIST_MIN
    ref_blocks = (
        comp.preload_ref(ref_part) if thresholded
        else comp.preload_rows(ref_part.hvs)
    )
    Q_CHUNK = 8192  # bounds per-host query memory when streaming from .hgdb
    rs, qs, asv = [], [], []
    for qlo in range(0, N, Q_CHUNK):
        qhi = min(qlo + Q_CHUNK, N)
        q_part = (
            load_db_rows(dp.path_query_sketch, qlo, qhi)
            if q_is_hgdb else _slice_db(query_full, qlo, qhi)
        )
        # global offsets make the symmetric i<j pair set exact across hosts
        # and let the comparator skip tiles entirely below the diagonal
        if thresholded:
            ri, qi, ani, _ = comp.ani_pairs_thresholded(
                ref_part, q_part, symmetric=if_sym,
                threshold=dp.ani_threshold,
                ref_blocks=ref_blocks, ref_offset=lo, query_offset=qlo,
            )
        else:
            ri, qi, ani, _ = comp.ani_pairs_streamed(
                ref_part, q_part, symmetric=if_sym,
                threshold=dp.ani_threshold,
                ref_blocks=ref_blocks, ref_offset=lo, query_offset=qlo,
            )
        rs.append((ri + lo).astype(np.int32))
        qs.append((qi + qlo).astype(np.int32))
        asv.append(ani)
    ri = np.concatenate(rs) if rs else np.zeros(0, np.int32)
    qi = np.concatenate(qs) if qs else np.zeros(0, np.int32)
    ani = np.concatenate(asv) if asv else np.zeros(0, np.float32)
    n_total = M * (M - 1) // 2 if if_sym else M * N
    out = Path(dp.out_file)
    part = out.with_suffix(out.suffix + f".part{pid:05d}.{token}.npz")
    np.savez(part, ri=ri, qi=qi, ani=ani)
    part.with_suffix(".done").write_text("ok")
    if pid != 0:
        return
    # process 0: wait for this run's parts, merge in enumeration order.
    # Parts load one at a time and indices stay int32 (12 B/pair + the
    # sort permutations) so a GTDB-scale merge does not blow host RAM.
    from hypergen_tpu.io.sketch_db import wait_for_part_files

    parts = [
        out.with_suffix(out.suffix + f".part{p:05d}.{token}.npz")
        for p in range(nproc)
    ]
    wait_for_part_files([p.with_suffix(".done") for p in parts])
    ri_l, qi_l, ani_l = [], [], []
    for p in parts:
        with np.load(p) as z:
            ri_l.append(z["ri"].astype(np.int32, copy=False))
            qi_l.append(z["qi"].astype(np.int32, copy=False))
            ani_l.append(z["ani"])
    ri, qi, ani = (
        np.concatenate(ri_l), np.concatenate(qi_l), np.concatenate(ani_l)
    )
    del ri_l, qi_l, ani_l
    order = np.lexsort((qi, ri))
    ri, qi, ani = ri[order], qi[order], ani[order]
    del order
    n_rep = write_ani_report(
        out, r_names, q_names, ri, qi, ani, dp.ani_threshold,
        top_k=dp.top_k,
    )
    for p in parts:
        p.unlink(missing_ok=True)
        p.with_suffix(".done").unlink(missing_ok=True)
    report_sparsity(n_rep, n_total, dp.ani_threshold)
    log.info(
        "Computed ANIs for %d ref files and %d query files took %.3fs",
        M, N, time.monotonic() - t0,
    )


def _slice_db(db, lo: int, hi: int):
    """Row-slice view of a ShardedDB (query streaming for non-.hgdb input)."""
    import dataclasses

    return dataclasses.replace(
        db, names=db.names[lo:hi], hvs=db.hvs[lo:hi], norms=db.norms[lo:hi]
    )


def run_search(args) -> None:
    from hypergen_tpu.parallel.search import run_search_cli

    run_search_cli(args, _load_db)


def run_hist(args) -> None:
    from hypergen_tpu.io.sketch_db import (
        hv_value_histogram, hv_value_histogram_sharded, load_sketch,
    )

    if args.path_r.is_dir():
        hist = hv_value_histogram_sharded(args.path_r)
    else:
        hist = hv_value_histogram(load_sketch(args.path_r))
    try:
        for value, count in sorted(hist.items()):
            print(f"{value}\t{count}")
    except BrokenPipeError:  # downstream `head` etc. closed the pipe
        sys.stderr.close()


def main(argv=None) -> None:
    from hypergen_tpu.utils.jaxcache import enable_compilation_cache

    from hypergen_tpu.utils.timing import maybe_profile

    from hypergen_tpu.backend import require_platform, select_platform

    setup_logging()
    enable_compilation_cache()
    args = build_parser().parse_args(argv)
    device = getattr(args, "device", None)
    select_platform(device)  # before the first backend touch
    # multi-host (pod) init, env-opt-in — must precede the first backend
    # touch; without it jax.process_count() stays 1 on every host and the
    # pod branches below silently degrade to N independent full runs
    from hypergen_tpu.parallel.mesh import maybe_init_distributed

    maybe_init_distributed()
    require_platform(device)
    with maybe_profile(os.environ.get("HG_TRACE_DIR", "")):
        if args.mode == P.CMD_SKETCH:
            run_sketch(args)
        elif args.mode == P.CMD_DIST:
            run_dist(args)
        elif args.mode == P.CMD_SEARCH:
            run_search(args)
        elif args.mode == "hist":
            run_hist(args)


if __name__ == "__main__":
    main()
