"""8-way decomposition of the kernel (pallas) backend: the CSR SpMM inside
shard_map on all 8 conftest devices (the Pallas interpreter on CPU), against
the single-device XLA reference, plus one grad-bearing CF step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax

from kgat_tpu.data import synthetic_dataset
from kgat_tpu.graph import host_coo
from kgat_tpu.models import kgat
from kgat_tpu.parallel.dp import make_mesh
from kgat_tpu.parallel.halo import AXIS, make_partitioned
from kgat_tpu.parallel.partition import partition_graph


def test_8way_pallas_matches_ref_with_spare_device():
    n = 8
    assert len(jax.devices()) == n  # conftest pins this: no spare needed
    ds = synthetic_dataset(seed=31, n_users=60, n_items=50, n_entities=90,
                           n_relations_kg=3, n_interactions=600,
                           n_triples=450)
    g, meta = ds.build()
    coo = host_coo(g)
    cfg = kgat.KGATConfig(ops_backend="pallas", interpret=True,
                          embed_dim=16, relation_dim=16, conv_dims=(16, 16),
                          mess_dropout=(0.0, 0.0))
    params = kgat.init_params(jax.random.key(2), meta.n_nodes,
                              meta.n_relations, cfg)
    mesh = make_mesh(n, axis=AXIS)
    pg, info = partition_graph(coo["src"], coo["dst"], coo["etype"],
                               meta.n_nodes, meta.n_relations, n,
                               rel_block=256)
    attention, propagate_eval, make_cf_step, _ = make_partitioned(
        mesh, pg, info, meta, cfg)
    _, ew = attention(pg, params)
    emb = propagate_eval(ew, params)

    cfg_ref = dataclasses.replace(cfg, ops_backend="ref")
    att_ref = jax.jit(
        lambda p: kgat.compute_attention(p, g, cfg_ref))(params)
    emb_ref = jax.jit(
        lambda p, a: kgat.propagate(p, g, a, cfg_ref))(params, att_ref)
    np.testing.assert_allclose(np.asarray(emb), np.asarray(emb_ref),
                               rtol=1e-4, atol=1e-4)

    opt = optax.adam(1e-3)
    b = 16
    u = jnp.arange(b, dtype=jnp.int32) % meta.n_users
    ip = jnp.arange(b, dtype=jnp.int32) % meta.n_items
    ineg = (jnp.arange(b, dtype=jnp.int32) + 3) % meta.n_items
    step = make_cf_step(opt)
    p2, _, loss = step(params, opt.init(params), ew, u, ip, ineg,
                       jnp.ones(b), jax.random.key(9))
    assert np.isfinite(float(loss))
    assert np.isfinite(np.asarray(p2["entity_embed"])).all()
