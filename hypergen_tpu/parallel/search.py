"""Sharded database search: per-shard ANI + collective top-k merge.

The BASELINE north star: reference sketch DB sharded across devices/hosts,
query batches streamed data-parallel, per-shard top hits merged with
all_gather. Realizes the reference's unimplemented `search` subcommand
(reference:src/main.rs:22-24) at multi-device scale.

Layout on a (db, q) mesh:
  db_hv   [M, D] int16  sharded P('db', None)
  db_norm [M]    int32  sharded P('db')
  q_hv    [N, D] int16  sharded P('q', None)   (replicated along db)
  q_norm  [N]    int32  sharded P('q')

Each device computes its local [M/db, N/q] exact-dot ANI tile, reduces to a
per-query local top-k, all_gathers the tiny [k] candidates over the db axis
(k*ndb << M, so the collective is small), and merges. Output is sharded over q and
replicated over db.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hypergen_tpu.backend import caps
from hypergen_tpu.ops.ani import ani_from_dot_matrix, dot_i16_exact
from hypergen_tpu.parallel.mesh import AXIS_DB, AXIS_Q, make_mesh

log = logging.getLogger("hypergen")


def _local_search(db_hv, db_norm, q_hv, q_norm, *, ksize: int, k_top: int,
                  int8_split: bool):
    """Per-shard body (runs under shard_map)."""
    m_local = db_hv.shape[0]
    dot = dot_i16_exact(db_hv, q_hv, int8_split=int8_split)  # [m_l, n_l] exact i32
    ani = ani_from_dot_matrix(dot, db_norm, q_norm, ksize)
    vals, idx = jax.lax.top_k(ani.T, min(k_top, m_local))  # [n_l, k']
    dots = jnp.take_along_axis(dot.T, idx, axis=1)
    if vals.shape[1] < k_top:  # shard smaller than k: pad with -inf
        pad = k_top - vals.shape[1]
        vals = jnp.pad(vals, ((0, 0), (0, pad)), constant_values=-jnp.inf)
        idx = jnp.pad(idx, ((0, 0), (0, pad)), constant_values=0)
        dots = jnp.pad(dots, ((0, 0), (0, pad)), constant_values=0)
    gidx = idx + jax.lax.axis_index(AXIS_DB) * m_local
    # gather candidates from every db shard: [ndb, n_l, k]
    av = jax.lax.all_gather(vals, AXIS_DB)
    ai = jax.lax.all_gather(gidx, AXIS_DB)
    ad = jax.lax.all_gather(dots, AXIS_DB)
    n_l = av.shape[1]
    av = jnp.moveaxis(av, 0, 1).reshape(n_l, -1)
    ai = jnp.moveaxis(ai, 0, 1).reshape(n_l, -1)
    ad = jnp.moveaxis(ad, 0, 1).reshape(n_l, -1)
    mv, mpos = jax.lax.top_k(av, k_top)
    mi = jnp.take_along_axis(ai, mpos, axis=1)
    md = jnp.take_along_axis(ad, mpos, axis=1)
    return mv, mi.astype(jnp.int32), md


@functools.lru_cache(maxsize=None)
def _search_fn(mesh: Mesh, ksize: int, k_top: int, int8_split: bool):
    """The jitted shard_map search program (shared by all entry points).

    Memoized: a fresh jit(shard_map(...)) object per call would miss pjit's
    cache and re-trace the program every tile (same pattern as
    seqpar._seqpar_fn)."""
    return jax.jit(
        jax.shard_map(
            functools.partial(
                _local_search, ksize=ksize, k_top=k_top, int8_split=int8_split
            ),
            mesh=mesh,
            in_specs=(P(AXIS_DB, None), P(AXIS_DB), P(AXIS_Q, None), P(AXIS_Q)),
            out_specs=(P(AXIS_Q, None), P(AXIS_Q, None), P(AXIS_Q, None)),
            # outputs are replicated over `db` by construction (post
            # all_gather merge), which the static checker can't infer
            check_vma=False,
        )
    )


def _mask_padding(ani, idx, dot, M, Mp, N):
    ani, idx, dot = ani[:N], idx[:N], dot[:N]
    # mask out padded DB rows (they can only appear when M < Mp)
    if Mp != M:
        bad = idx >= M
        ani = np.where(bad, -np.inf, ani)
        idx = np.where(bad, 0, idx)
        dot = np.where(bad, 0, dot)
    return ani, idx, dot


def sharded_topk_search(
    mesh: Mesh,
    db_hv: np.ndarray,
    db_norm: np.ndarray,
    q_hv: np.ndarray,
    q_norm: np.ndarray,
    ksize: int,
    k_top: int,
    int8_split: bool | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k ANI search of queries against a device-sharded DB.

    Pads M to the db-axis size and N to the q-axis size; padding DB rows are
    zero HVs (ANI NaN->0) and sliced out of results by global index masking.
    Returns (ani [N, k_top] float32, idx [N, k_top] int32 global DB rows,
    dot [N, k_top] exact int32 dots for the winners — the TSV path feeds
    these through the host float chain for dist-identical values).
    """
    int8_split = _resolve_split(int8_split, db_hv, q_hv)
    ndb = mesh.shape[AXIS_DB]
    nq = mesh.shape[AXIS_Q]
    M, N = db_hv.shape[0], q_hv.shape[0]
    Mp = -(-M // ndb) * ndb
    Np = -(-N // nq) * nq
    fn = _search_fn(mesh, ksize, k_top, int8_split)
    sh = lambda spec: NamedSharding(mesh, spec)
    args = (
        jax.device_put(_pad_rows(db_hv, Mp), sh(P(AXIS_DB, None))),
        jax.device_put(_pad_rows(db_norm, Mp), sh(P(AXIS_DB))),
        jax.device_put(_pad_rows(q_hv, Np), sh(P(AXIS_Q, None))),
        jax.device_put(_pad_rows(q_norm, Np), sh(P(AXIS_Q))),
    )
    ani, idx, dot = jax.device_get(fn(*args))
    return _mask_padding(ani, idx, dot, M, Mp, N)


def multihost_topk_search(
    db_dir,
    q_hv: np.ndarray,
    q_norm: np.ndarray,
    ksize: int,
    k_top: int,
    int8_split: bool | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pod-scale DB search: every host loads ONLY its devices' DB rows.

    The .hgdb manifest defines global row order; each global device owns a
    contiguous row range, and each process mmap-loads just the ranges of its
    addressable devices (load_db_rows), so a GTDB-scale database never
    materializes on any single host. The global [M, D] array is assembled
    with jax.make_array_from_single_device_arrays and searched with the
    same shard_map program as the single-host path; queries are replicated
    (they are tiny next to the DB).

    Call after jax.distributed.initialize (mesh.init_distributed). Returns
    (ani [N, k_top], idx [N, k_top], dot [N, k_top]) — replicated,
    identical on all hosts.
    """
    import json
    from pathlib import Path as _Path

    from hypergen_tpu.io.sketch_db import load_db_rows

    if int8_split is None:
        int8_split = caps().dot_mode
    manifest = json.loads((_Path(db_dir) / "manifest.json").read_text())
    M, D = manifest["n_genomes"], manifest["hv_d"]
    devices = jax.devices()
    ndb = len(devices)
    mesh = make_mesh(ndb, 1, devices=devices)
    Mp = -(-M // ndb) * ndb
    rp = Mp // ndb
    N = q_hv.shape[0]

    hv_bufs, norm_bufs = [], []
    for di, dev in enumerate(devices):
        if dev.process_index != jax.process_index():
            continue
        lo, hi = di * rp, min((di + 1) * rp, M)
        local = load_db_rows(db_dir, lo, min(hi, M))
        hv_bufs.append(jax.device_put(_pad_rows(local.hvs, rp), dev))
        norm_bufs.append(jax.device_put(_pad_rows(local.norms, rp), dev))
    sh = lambda spec: NamedSharding(mesh, spec)
    db_hv = jax.make_array_from_single_device_arrays(
        (Mp, D), sh(P(AXIS_DB, None)), hv_bufs
    )
    db_norm = jax.make_array_from_single_device_arrays(
        (Mp,), sh(P(AXIS_DB)), norm_bufs
    )
    q_dev = jax.device_put(q_hv, sh(P(AXIS_Q, None)))
    qn_dev = jax.device_put(q_norm, sh(P(AXIS_Q)))

    fn = _search_fn(mesh, ksize, k_top, int8_split)
    ani_g, idx_g, dot_g = fn(db_hv, db_norm, q_dev, qn_dev)
    # outputs are replicated (q axis is 1, db-merged): read the local copy
    ani = np.asarray(ani_g.addressable_data(0))
    idx = np.asarray(idx_g.addressable_data(0))
    dot = np.asarray(dot_g.addressable_data(0))
    return _mask_padding(ani, idx, dot, M, Mp, N)


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _resolve_split(int8_split, *hv_arrays):
    """None -> backend default; True -> upgrade to the 3-matmul "small"
    split when every HV value fits (single-host only: the mode is a static
    compile flag, so multihost callers must agree without communicating)."""
    from hypergen_tpu.ops.ani import SMALL_SPLIT_MAX, abs_bound

    if int8_split is None:
        int8_split = caps().dot_mode
    if int8_split is True and all(
        abs_bound(a) <= SMALL_SPLIT_MAX for a in hv_arrays
    ):
        return "small"
    return int8_split


@functools.partial(jax.jit, static_argnames=("ksize", "k_top", "int8_split"))
def _topk_tile_merge(db_tile, dbn_tile, q, qn, run_v, run_i, run_d, offset,
                     ksize: int, k_top: int, int8_split: bool):
    from hypergen_tpu.ops.ani import ani_topk

    v, i, d = ani_topk(db_tile, dbn_tile, q, qn, ksize, k_top, int8_split=int8_split)
    cv = jnp.concatenate([run_v, v], axis=1)
    ci = jnp.concatenate([run_i, i + offset], axis=1)
    cd = jnp.concatenate([run_d, d], axis=1)
    mv, mp = jax.lax.top_k(cv, k_top)
    return (
        mv,
        jnp.take_along_axis(ci, mp, axis=1),
        jnp.take_along_axis(cd, mp, axis=1),
    )


def local_topk_search_tiled(
    db_hv: np.ndarray,
    db_norm: np.ndarray,
    q_hv: np.ndarray,
    q_norm: np.ndarray,
    ksize: int,
    k_top: int,
    tile_m: int = 8192,
    int8_split: bool | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Single-device top-k over a DB larger than one ANI matrix dispatch.

    Streams DB row tiles through a running on-device top-k merge, so peak
    memory is O(tile_m x N) instead of O(M x N) — the single-device analog of
    the sharded pod search (a 500k-genome DB at D=4096 is 4 GB of HVs but
    would need a 500k x n_q float matrix in one shot).
    """
    int8_split = _resolve_split(int8_split, db_hv, q_hv)
    import jax.numpy as _jnp

    tile_m = max(tile_m, k_top)  # top_k needs >= k_top candidates per tile
    M, N = db_hv.shape[0], q_hv.shape[0]
    q_dev = _jnp.asarray(q_hv)
    qn_dev = _jnp.asarray(q_norm)
    run_v = _jnp.full((N, k_top), -_jnp.inf, dtype=_jnp.float32)
    run_i = _jnp.zeros((N, k_top), dtype=_jnp.int32)
    run_d = _jnp.zeros((N, k_top), dtype=_jnp.int32)
    for mi in range(0, M, tile_m):
        tile = _pad_rows(db_hv[mi : mi + tile_m], tile_m)
        tn = _pad_rows(db_norm[mi : mi + tile_m], tile_m)
        run_v, run_i, run_d = _topk_tile_merge(
            _jnp.asarray(tile), _jnp.asarray(tn), q_dev, qn_dev,
            run_v, run_i, run_d, _jnp.int32(mi), ksize, k_top, int8_split,
        )
    ani = np.asarray(run_v)
    idx = np.asarray(run_i)
    dot = np.asarray(run_d)
    bad = idx >= M  # padded rows of the last tile
    return (
        np.where(bad, -np.inf, ani),
        np.where(bad, 0, idx),
        np.where(bad, 0, dot),
    )


def sharded_topk_search_tiled(
    mesh: Mesh,
    db_hv: np.ndarray,
    db_norm: np.ndarray,
    q_hv: np.ndarray,
    q_norm: np.ndarray,
    ksize: int,
    k_top: int,
    tile_m: int,
    int8_split: bool | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Multi-device top-k over a DB too large for one sharded dispatch.

    Streams DB row tiles through the memoized shard_map program and merges
    the per-tile top-k candidates on the host, bounding per-device memory at
    O(tile_m/ndb x N) — the multi-device analog of local_topk_search_tiled
    (which this degenerates to conceptually at ndb == 1, kept separate
    because its merge stays on device).

    Queries upload once and stay device-resident; every tile pads to the
    same tile_m so ONE compiled program serves the whole loop (a
    different-shaped last tile would cost an extra compile), and
    int8_split resolves once over the full arrays so the split mode cannot
    flip between tiles.
    """
    int8_split = _resolve_split(int8_split, db_hv, q_hv)
    ndb = mesh.shape[AXIS_DB]
    nq = mesh.shape[AXIS_Q]
    M, N = db_hv.shape[0], q_hv.shape[0]
    tile_m = -(-max(tile_m, k_top) // ndb) * ndb
    Np = -(-N // nq) * nq
    sh = lambda spec: NamedSharding(mesh, spec)
    q_dev = jax.device_put(_pad_rows(q_hv, Np), sh(P(AXIS_Q, None)))
    qn_dev = jax.device_put(_pad_rows(q_norm, Np), sh(P(AXIS_Q)))
    fn = _search_fn(mesh, ksize, k_top, int8_split)
    run_v = np.full((N, k_top), -np.inf, dtype=np.float32)
    run_i = np.zeros((N, k_top), dtype=np.int32)
    run_d = np.zeros((N, k_top), dtype=np.int32)
    for mi in range(0, M, tile_m):
        rows = min(tile_m, M - mi)
        v, i, d = jax.device_get(fn(
            jax.device_put(
                _pad_rows(db_hv[mi : mi + tile_m], tile_m),
                sh(P(AXIS_DB, None)),
            ),
            jax.device_put(
                _pad_rows(db_norm[mi : mi + tile_m], tile_m), sh(P(AXIS_DB))
            ),
            q_dev, qn_dev,
        ))
        v, i, d = _mask_padding(v, i, d, rows, tile_m, N)
        cv = np.concatenate([run_v, v], axis=1)
        ci = np.concatenate([run_i, i + mi], axis=1)
        cd = np.concatenate([run_d, d], axis=1)
        pos = np.argsort(-cv, axis=1, kind="stable")[:, :k_top]
        run_v = np.take_along_axis(cv, pos, axis=1)
        run_i = np.take_along_axis(ci, pos, axis=1).astype(np.int32)
        run_d = np.take_along_axis(cd, pos, axis=1).astype(np.int32)
    return run_v, run_i, run_d


# per-device ANI-matrix budget above which DB search streams row tiles
# instead of materializing the full (M/ndb x N) matrix in one dispatch
PAIRS_PER_DEVICE_TILE_LIMIT = 1 << 28


def run_search_cli(args, load_db) -> None:
    """CLI glue for the `search` subcommand.

    Output rows are byte-consistent with `dist`: same `ref\\tquery\\tani`
    column order (reference:src/utils.rs:272-286) and ANI recomputed on
    host from the winners' exact int32 dots (the device float chain only
    RANKS candidates; its O(1e-4) drift never reaches the TSV)."""
    import json
    from pathlib import Path as _Path

    from hypergen_tpu.models.comparator import _ani_host_pairs

    t0 = time.monotonic()
    query_db = load_db(args.path_q)
    if (
        jax.process_count() > 1
        and _Path(args.path_r).is_dir()
    ):
        # pod mode: every host loads only its devices' DB rows
        from hypergen_tpu.io.sketch_db import load_db_norms

        manifest = json.loads(
            (_Path(args.path_r) / "manifest.json").read_text()
        )
        if manifest["ksize"] != query_db.ksize or manifest["hv_d"] != query_db.hv_d:
            raise SystemExit("ref/query sketch parameter mismatch")
        k_top = min(args.top_k, manifest["n_genomes"])
        ani, idx, dot = multihost_topk_search(
            args.path_r, query_db.hvs, query_db.norms,
            ksize=query_db.ksize, k_top=k_top,
        )
        ref_db_names = manifest["names"]
        ref_norms = load_db_norms(args.path_r)
        n_refs = manifest["n_genomes"]
    else:
        ref_db = load_db(args.path_r)
        if ref_db.ksize != query_db.ksize or ref_db.hv_d != query_db.hv_d:
            raise SystemExit("ref/query sketch parameter mismatch")
        M, N = ref_db.hvs.shape[0], query_db.hvs.shape[0]
        k_top = min(args.top_k, M)
        ndev = jax.device_count()
        # gate on the per-DEVICE pair count: a multi-device host with a DB
        # large enough to need tiling must stream too, not OOM
        per_dev_pairs = -(-M // ndev) * N
        if per_dev_pairs <= PAIRS_PER_DEVICE_TILE_LIMIT:
            mesh = make_mesh()
            ani, idx, dot = sharded_topk_search(
                mesh, ref_db.hvs, ref_db.norms, query_db.hvs, query_db.norms,
                ksize=ref_db.ksize, k_top=k_top,
            )
        elif ndev == 1:
            # stream row tiles through a running on-device top-k merge;
            # size the tile from the SAME per-device pair budget that
            # routed us here (the fixed default would exceed it at large N)
            ani, idx, dot = local_topk_search_tiled(
                ref_db.hvs, ref_db.norms, query_db.hvs, query_db.norms,
                ksize=ref_db.ksize, k_top=k_top,
                tile_m=max(
                    k_top, 256, PAIRS_PER_DEVICE_TILE_LIMIT // max(N, 1)
                ),
            )
        else:
            mesh = make_mesh()
            tile_m = max(8192, PAIRS_PER_DEVICE_TILE_LIMIT // max(N, 1) * ndev)
            ani, idx, dot = sharded_topk_search_tiled(
                mesh, ref_db.hvs, ref_db.norms, query_db.hvs, query_db.norms,
                ksize=ref_db.ksize, k_top=k_top, tile_m=tile_m,
            )
        ref_db_names = ref_db.names
        ref_norms = ref_db.norms
        n_refs = M
    # exact host-chain ANI for the winners: identical f32 ops (and thus
    # identical 3-decimal rounding) to the dist TSV path
    N = ani.shape[0]
    exact = _ani_host_pairs(
        dot.ravel().astype(np.int32),
        np.asarray(ref_norms)[idx.ravel()],
        np.repeat(np.asarray(query_db.norms), k_top) if k_top else
        np.zeros(0, np.int32),
        query_db.ksize,
    ).reshape(N, k_top)
    # -inf marks short-shard / padded-row slots; NaN them out so the shared
    # reference-exact writer (stable-sort-reversed ties, '%.3f', threshold
    # cut — reference:src/utils.rs:262-269) drops them. The streamed
    # per-query writer keeps the TSV contract byte-identical to
    # format_ani_report while assembling rows vectorized in bounded chunks
    # (a 50k-query top-k report no longer builds 50k Python strings).
    from hypergen_tpu.models.comparator import (
        count_search_hits,
        write_search_report,
    )

    exact = np.where(np.isfinite(ani), exact, np.nan)
    if jax.process_index() == 0:  # results replicated across hosts
        n_hits = write_search_report(
            args.out, ref_db_names, query_db.names, idx, exact, args.ani_th
        )
    else:
        n_hits = count_search_hits(exact, args.ani_th)
    log.info(
        "Searched %d queries against %d refs (top-%d) in %.3fs -> %d hits",
        N, n_refs, k_top,
        time.monotonic() - t0, n_hits,
    )
