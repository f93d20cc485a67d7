"""Multi-process (multi-host analog) worker — run by test_multihost_2proc.py.

Forms a REAL ``jax.distributed`` process group over localhost — the DCN
path of SURVEY.md §2.3 / §M5, with gloo standing in for the pod's DCN
collectives on CPU — as ``nproc`` processes x ``8 // nproc`` virtual
devices each, then drives the edge-partitioned trainer machinery over the
8-device GLOBAL mesh:

* ``partition_graph(..., mesh=mesh)`` assembles the stacked shard Graph
  via ``multihost.stack_pytrees`` — each process materializes only its
  OWN devices' shards (``make_array_from_callback``), exactly the
  multi-host data-loading contract.
* attention + propagate + one partitioned CF step + one DP KG step then
  run with their activation exchanges crossing the process boundary.

Prints one RESULT line; the test asserts every process (and the
single-process oracle, ``nproc=1``) agrees on the losses and the
propagated-embedding fingerprint.

Usage: python mp_worker.py <pid> <nproc> <port> [ndev]

ndev is the GLOBAL mesh size (default 8).
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
ndev = int(sys.argv[4]) if len(sys.argv) > 4 else 8
per = ndev // nproc
os.environ["XLA_FLAGS"] = (
    f"--xla_force_host_platform_device_count={per} "
    + os.environ.get("XLA_FLAGS", ""))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_PLATFORM_NAME"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from kgat_tpu.parallel.multihost import initialize_distributed  # noqa: E402

if nproc > 1:
    initialize_distributed(f"localhost:{port}", nproc, pid)
assert jax.device_count() == nproc * per, jax.devices()
assert jax.local_device_count() == per
assert jax.process_index() == pid

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from kgat_tpu.data import synthetic_dataset  # noqa: E402
from kgat_tpu.graph import host_coo  # noqa: E402
from kgat_tpu.models import kgat  # noqa: E402
from kgat_tpu.parallel import make_dp_kg_step, make_mesh  # noqa: E402
from kgat_tpu.parallel.halo import AXIS, make_partitioned  # noqa: E402
from kgat_tpu.parallel.partition import partition_graph  # noqa: E402
from kgat_tpu.sampler import (CFSampleTable, KGSampleTable,  # noqa: E402
                              sample_cf_batch, sample_kg_batch)

# Deterministic host-side setup: every process builds the identical
# dataset + params (the multi-host contract — same program, same data).
ds = synthetic_dataset(seed=11, n_users=48, n_items=40, n_entities=80,
                       n_relations_kg=4, n_interactions=500, n_triples=400)
g, meta = ds.build()
coo = host_coo(g)
cfg = kgat.KGATConfig(ops_backend="ref")
params = jax.tree.map(np.asarray, kgat.init_params(
    jax.random.key(0), meta.n_nodes, meta.n_relations, cfg))

def _mark(msg):  # progress markers: diagnose hangs under timeouts
    print(f"# pid={pid} {msg}", file=sys.stderr, flush=True)


mesh = make_mesh(ndev, axis=AXIS)
my_shards = [i for i, d in enumerate(mesh.devices.flat)
             if d.process_index == pid]
assert len(my_shards) == per
pg, info = partition_graph(coo["src"], coo["dst"], coo["etype"],
                           meta.n_nodes, meta.n_relations, ndev, mesh=mesh)
_mark("partitioned")
attention, propagate_eval, make_cf_step, make_cf_scan = make_partitioned(
    mesh, pg, info, meta, cfg)
_, ew = attention(pg, params)
_mark("attention done")
emb = propagate_eval(ew, params)
fp = float(jax.jit(lambda e: jnp.vdot(e, e))(emb))
_mark("eval propagate done")

opt = optax.adam(1e-3)
cf_step = make_cf_step(opt)
cf_table = CFSampleTable.build(ds.cf_train, meta.n_users, meta.n_items)
u, ip, ineg, w = (np.asarray(x) for x in
                  sample_cf_batch(cf_table, jax.random.key(1), 16))
params2, _, cf_l = cf_step(params, opt.init(params), ew, u, ip, ineg, w,
                           jax.random.key(2))
_mark("cf step done")

kg_step = make_dp_kg_step(mesh, cfg, opt, axis=AXIS)
tri = np.stack([coo["dst"], coo["etype"], coo["src"]], axis=1)
kg_table = KGSampleTable.build(tri, meta.n_nodes, meta.n_relations)
h, r, tpos, tneg, _w = (np.asarray(x) for x in
                        sample_kg_batch(kg_table, jax.random.key(3), 16))
params3, _, kg_l = kg_step(params2, opt.init(params2), h, r, tpos, tneg)
_mark("kg step done")

# The production hot loop: device-resident chunked CF scan (pre-jitted,
# global graph passed through the jit boundary — see halo.make_cf_scan).
scan = make_cf_scan(opt, cf_table, 16)
_, _, cf_sum = scan(params3, opt.init(params3), ew,
                    jax.random.split(jax.random.key(4), 3))
assert np.isfinite(float(cf_sum))

print(f"RESULT pid={pid} nproc={nproc} shards={my_shards} "
      f"cf={float(cf_l):.8f} kg={float(kg_l):.8f} fp={fp:.6f}", flush=True)
if nproc > 1:
    jax.distributed.shutdown()
