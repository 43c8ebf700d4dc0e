"""Multi-device / multi-host parallelism.

The reference is a single-process tool whose only parallelism is rayon
thread pools over files/pairs (SURVEY §2.3). The device-mesh equivalents:

  - mesh axes ``(db, q)``: the sketch DB is sharded across ``db`` (model/DB
    parallelism), query batches across ``q`` (data parallelism);
  - ANI search = local exact-dot matmul per shard + per-shard top-k + ``all_gather``
    over ``db`` + merged top-k (parallel.search);
  - sketching is data-parallel over genomes/chunks across the whole mesh;
  - multi-host via ``jax.distributed.initialize`` (parallel.mesh), with
    sketch DB shards resident per host via io.sketch_db manifests.
"""

from hypergen_tpu.parallel.mesh import make_mesh  # noqa: F401
from hypergen_tpu.parallel.search import sharded_topk_search  # noqa: F401
