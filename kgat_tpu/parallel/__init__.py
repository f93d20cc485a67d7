"""Parallelism: device meshes, data-parallel training, edge partitioning.

The reference is single-GPU/single-process (SURVEY.md §2.3); everything in
this package is new capability required by the north-star (BASELINE.json:5):
data-parallel minibatching over a device mesh, and edge partitioning of the
CKG with boundary-embedding exchange for multi-device scaling.
"""

from kgat_tpu.parallel.dp import make_mesh, make_dp_cf_step, make_dp_kg_step  # noqa: F401
