"""Columnar ingest & commit engine (the `ColumnarIngest` gate, on by
default).

The device path compiles any pod mix into one program, so Python owns
most of a drain: pod ingest and the commit were per-pod object walks on
both edges of it. This package replaces those edges with columnar,
vectorized host pipelines, as the JAX package's `ingest/` does:

- `columns.py` — vectorized signature tensorize: `fill_rows` turns
  `BatchBuilder._fill_row`'s per-pod field walks into numpy batch ops
  over per-chunk column buffers (one write per PodTable column per
  chunk, bit for bit the serial filler), plus the per-row `CommitFacts`
  column the commit engine consumes.
- `noderows.py` — columnar node-row tensorize: `write_rows` batches
  `ClusterState._write_row`'s scalar stores per node into one scatter
  per NodeArrays field (prime, reseeds, mass updates).
- `commit.py` — the batched assume/bind pass over a resolved drain,
  driven by CommitFacts, and one bulk dispatcher enqueue; the bulk
  bind-echo confirm is `Scheduler._on_pod_update_bulk`.
- `groupcols.py` — per-statics-generation columnar node label store and
  the vectorized id→count gather behind the group-tensor seeding.

With the gate off the Scheduler runs the serial paths these replace
(`BatchBuilder._lookup` a pod, the per-row node writers, the per-pod
commit and informer echo): the parity oracle, as in the JAX package.
"""

from .columns import CommitFacts, commit_facts_for_row, fill_rows  # noqa: F401
