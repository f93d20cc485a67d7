"""The multi-device configuration with the SpMM kernel: the pallas backend
inside shard_map, each shard running the CSR kernel over its own pieces
(in the Pallas interpreter on CPU), compared with the single-device kernel
path and the XLA reference. A 4-device mesh keeps the interpreter quick;
tests/test_partition_pallas_8way.py covers all 8 devices.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from kgat_tpu.data import synthetic_dataset
from kgat_tpu.graph import host_coo
from kgat_tpu.models import kgat
from kgat_tpu.models.kgat import KGATConfig
from kgat_tpu.parallel.dp import make_mesh
from kgat_tpu.parallel.halo import AXIS, make_partitioned
from kgat_tpu.parallel.partition import (build_ring_buckets,
                                         build_selective_halo,
                                         partition_graph)

N = 4


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_dataset(seed=31, n_users=60, n_items=50, n_entities=90,
                           n_relations_kg=3, n_interactions=600,
                           n_triples=450)
    g, meta = ds.build()
    coo = host_coo(g)
    mesh = make_mesh(N, axis=AXIS)
    pg, info = partition_graph(coo["src"], coo["dst"], coo["etype"],
                               meta.n_nodes, meta.n_relations, N,
                               rel_block=256)
    cfg = KGATConfig(ops_backend="pallas", interpret=True, embed_dim=16,
                     relation_dim=16, conv_dims=(16, 16),
                     mess_dropout=(0.0, 0.0))
    params = kgat.init_params(jax.random.key(2), meta.n_nodes,
                              meta.n_relations, cfg)
    # Single-device oracles on the SAME params: the XLA ref path and the
    # single-device pallas path (also interpreted on CPU).
    cfg_ref = dataclasses.replace(cfg, ops_backend="ref")
    att_ref = jax.jit(
        lambda p: kgat.compute_attention(p, g, cfg_ref))(params)
    emb_ref = jax.jit(
        lambda p, a: kgat.propagate(p, g, a, cfg_ref))(params, att_ref)
    return ds, g, meta, coo, mesh, pg, info, cfg, params, att_ref, emb_ref


def test_partitioned_pallas_matches_single_pallas_and_ref(setup):
    """partitioned-pallas == single-device-pallas == ref for attention +
    propagate (VERDICT r2 item 1's 'done' criterion)."""
    ds, g, meta, coo, mesh, pg, info, cfg, params, att_ref, emb_ref = setup

    attention, propagate_eval, _, _ = make_partitioned(
        mesh, pg, info, meta, cfg)
    att_stack, ew_stack = attention(pg, params)
    emb_p = propagate_eval(ew_stack, params)

    # Single-device pallas (XLA attention + the CSR SpMM kernel).
    ew_s = jax.jit(
        lambda p: kgat.attention_for_training(p, g, cfg))(params)
    emb_s = jax.jit(
        lambda p, a: kgat.propagate(p, g, a, cfg))(params, ew_s)

    np.testing.assert_allclose(np.asarray(emb_s), np.asarray(emb_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(emb_p), np.asarray(emb_ref),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(emb_p), np.asarray(emb_s),
                               rtol=1e-4, atol=1e-4)

    # Per-edge attention parity vs the ref oracle, keyed by (src,dst,ety).
    att_np = np.asarray(att_ref)
    want = {(int(s), int(d), int(t)): float(a)
            for s, d, t, a in zip(coo["src"], coo["dst"], coo["etype"],
                                  att_np[: g.n_edges])}
    att_p = np.asarray(att_stack)
    masks = np.asarray(pg.edge_mask)
    srcs, dsts, etys = (np.asarray(pg.src), np.asarray(pg.dst),
                        np.asarray(pg.etype))
    checked = 0
    for p in range(info.n_parts):
        real = np.nonzero(masks[p] > 0)[0]
        for e in real:
            key = (int(srcs[p][e]), int(dsts[p][e]), int(etys[p][e]))
            np.testing.assert_allclose(att_p[p][e], want[key],
                                       rtol=1e-4, atol=1e-6)
            checked += 1
    assert checked == g.n_edges


def test_partitioned_pallas_cf_step_matches_single(setup):
    """One grad-bearing CF step through the pallas kernels' custom VJPs
    inside shard_map == the single-device pallas step."""
    ds, g, meta, coo, mesh, pg, info, cfg, params, att_ref, emb_ref = setup
    opt = optax.adam(1e-3)
    B = 16
    u = jnp.arange(B, dtype=jnp.int32) % meta.n_users
    ip = jnp.arange(B, dtype=jnp.int32) % meta.n_items
    ineg = (jnp.arange(B, dtype=jnp.int32) + 3) % meta.n_items
    w = jnp.ones(B)
    rng = jax.random.key(9)

    attention, _, make_cf_step, _ = make_partitioned(
        mesh, pg, info, meta, cfg)
    _, ew_stack = attention(pg, params)
    step = make_cf_step(opt)
    p_p, _, loss_p = step(jax.tree.map(jnp.copy, params),
                          opt.init(params), ew_stack, u, ip, ineg, w, rng)

    ew_s = jax.jit(
        lambda p: kgat.attention_for_training(p, g, cfg))(params)

    @jax.jit
    def single(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: kgat.cf_loss(p, g, ew_s, meta, u, ip, ineg, cfg,
                                   rng=rng, train=True, weight=w))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), loss

    p_s, loss_s = single(jax.tree.map(jnp.copy, params), opt.init(params))
    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=1e-4)
    np.testing.assert_allclose(np.asarray(p_p["entity_embed"]),
                               np.asarray(p_s["entity_embed"]), atol=2e-5)


@pytest.mark.parametrize("exchange", ["ring", "a2a"])
def test_partitioned_pallas_exchanges_match_ref(setup, exchange):
    """The overlapped ring and selective-halo a2a exchanges (XLA bucket
    reduces, under the pallas config) reproduce the single-device
    result."""
    ds, g, meta, coo, mesh, pg, info, cfg, params, att_ref, emb_ref = setup
    if exchange == "ring":
        extra = dict(ring_buckets=build_ring_buckets(
            coo["src"], coo["dst"], info))
    else:
        extra = dict(sel_halo=build_selective_halo(
            coo["src"], coo["dst"], info, chunk_edges=256))
    attention, propagate_eval, _, _ = make_partitioned(
        mesh, pg, info, meta, cfg, exchange=exchange, **extra)
    _, ew = attention(pg, params)
    emb_p = propagate_eval(ew, params)
    np.testing.assert_allclose(np.asarray(emb_p), np.asarray(emb_ref),
                               rtol=1e-4, atol=1e-4)


def test_partitioned_bf16_streams_match_f32(setup):
    """compute_dtype=bf16 partitioned execution (the production config):
    the SpMM kernel's feature AND cotangent streams run bf16 (mirroring
    pallas_backend._spmm_bwd) while aggregator math and accumulation stay
    f32. Propagation must track the f32 partitioned
    result to bf16-rounding tolerance, and a grad-bearing CF step (whose
    backward reduces a bf16-cast cotangent) must match the single-device
    bf16 pallas step."""
    ds, g, meta, coo, mesh, pg, info, cfg, params, att_ref, emb_ref = setup
    cfg16 = dataclasses.replace(cfg, compute_dtype=jnp.bfloat16)

    attention, propagate_eval, make_cf_step, _ = make_partitioned(
        mesh, pg, info, meta, cfg16)
    _, ew = attention(pg, params)
    assert ew.fwd.dtype == jnp.float32  # weights stay f32; features bf16
    emb16 = propagate_eval(ew, params)
    # bf16 value streams: ~1e-2 relative activation noise vs f32.
    np.testing.assert_allclose(np.asarray(emb16), np.asarray(emb_ref),
                               rtol=3e-2, atol=3e-2)

    opt = optax.adam(1e-3)
    B = 16
    u = jnp.arange(B, dtype=jnp.int32) % meta.n_users
    ip = jnp.arange(B, dtype=jnp.int32) % meta.n_items
    ineg = (jnp.arange(B, dtype=jnp.int32) + 3) % meta.n_items
    w = jnp.ones(B)
    rng = jax.random.key(9)
    step = make_cf_step(opt)
    p_p, _, loss_p = step(jax.tree.map(jnp.copy, params),
                          opt.init(params), ew, u, ip, ineg, w, rng)
    assert np.isfinite(float(loss_p))
    assert np.isfinite(np.asarray(p_p["entity_embed"])).all()

    # Parity vs the single-device bf16 pallas path. Post-Adam params are
    # not compared elementwise: Adam divides by sqrt(v), so bf16
    # sum-order noise on near-zero grads flips signs and moves single
    # entries by up to ~2*lr. Compare the loss and the DIRECTION of the
    # embedding-table update (cosine similarity of the deltas) instead.
    ew_s = jax.jit(
        lambda p: kgat.attention_for_training(p, g, cfg16))(params)

    @jax.jit
    def single(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: kgat.cf_loss(p, g, ew_s, meta, u, ip, ineg, cfg16,
                                   rng=rng, train=True, weight=w))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), loss

    p_s, loss_s = single(jax.tree.map(jnp.copy, params), opt.init(params))
    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=3e-2)
    e0 = np.asarray(params["entity_embed"], np.float32)
    d_p = (np.asarray(p_p["entity_embed"], np.float32) - e0).ravel()
    d_s = (np.asarray(p_s["entity_embed"], np.float32) - e0).ravel()
    cos = float(d_p @ d_s / (np.linalg.norm(d_p) * np.linalg.norm(d_s)))
    assert cos > 0.97, f"update direction diverged: cos={cos}"
    np.testing.assert_allclose(np.linalg.norm(d_p), np.linalg.norm(d_s),
                               rtol=0.1)
