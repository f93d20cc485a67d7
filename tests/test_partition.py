"""Edge-partitioned execution vs single-device (SURVEY.md §4.3: fake
multi-chip with 8 virtual CPU devices; partitioned output must match the
single-device result within fp32 sum-order tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from kgat_tpu.data import synthetic_dataset
from kgat_tpu.models import kgat
from kgat_tpu.models.kgat import KGATConfig
from kgat_tpu.parallel.dp import make_mesh
from kgat_tpu.parallel.halo import AXIS, make_partitioned
from kgat_tpu.parallel.partition import partition_graph


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_dataset(seed=21, n_users=80, n_items=60, n_entities=120,
                           n_relations_kg=3, n_interactions=900,
                           n_triples=700)
    g, meta = ds.build()
    src = np.asarray(g.src)[: g.n_edges]
    dst = np.asarray(g.dst)[: g.n_edges]
    ety = np.asarray(g.etype)[: g.n_edges]
    mesh = make_mesh(8, axis=AXIS)
    pg, info = partition_graph(src, dst, ety, meta.n_nodes,
                               meta.n_relations, 8)
    # ref backend here; the kernel inside shard_map is
    # tests/test_partition_pallas.py.
    cfg = KGATConfig(ops_backend="ref")
    params = kgat.init_params(jax.random.key(0), meta.n_nodes,
                              meta.n_relations, cfg)
    return g, meta, mesh, pg, info, cfg, params


def test_partition_covers_all_edges(setup):
    g, meta, mesh, pg, info, cfg, params = setup
    # Every real edge appears in exactly one shard, dst in that shard's range.
    masks = np.asarray(pg.edge_mask)            # (P, E_pad)
    assert int(masks.sum()) == g.n_edges
    dsts = np.asarray(pg.dst)
    for p in range(info.n_parts):
        real = masks[p] > 0
        d = dsts[p][real]
        assert ((d >= p * info.rows_per_part)
                & (d < (p + 1) * info.rows_per_part)).all()


def test_partitioned_attention_and_propagate_match_single(setup):
    g, meta, mesh, pg, info, cfg, params = setup
    att_s = kgat.compute_attention(params, g, cfg)
    emb_s = kgat.propagate(params, g, att_s, cfg)

    attention, propagate_eval, _, _ = make_partitioned(
        mesh, pg, info, meta, cfg)
    att_stack, ew_stack = attention(pg, params)
    emb_p = propagate_eval(ew_stack, params)

    # Attention values: compare per-edge via (src, dst, etype) keys.
    att_s = np.asarray(att_s)
    src_s = np.asarray(g.src)[: g.n_edges]
    dst_s = np.asarray(g.dst)[: g.n_edges]
    ety_s = np.asarray(g.etype)[: g.n_edges]
    want = {(int(s), int(d), int(t)): float(a)
            for s, d, t, a in zip(src_s, dst_s, ety_s, att_s[: g.n_edges])}
    att_p = np.asarray(att_stack)
    masks = np.asarray(pg.edge_mask)
    srcs, dsts, etys = (np.asarray(pg.src), np.asarray(pg.dst),
                        np.asarray(pg.etype))
    checked = 0
    for p in range(info.n_parts):
        for e in np.nonzero(masks[p] > 0)[0]:
            key = (int(srcs[p][e]), int(dsts[p][e]), int(etys[p][e]))
            np.testing.assert_allclose(att_p[p][e], want[key],
                                       rtol=1e-4, atol=1e-6)
            checked += 1
    assert checked == g.n_edges

    np.testing.assert_allclose(np.asarray(emb_p), np.asarray(emb_s),
                               rtol=1e-4, atol=1e-4)


def test_partitioned_cf_step_matches_single(setup):
    g, meta, mesh, pg, info, cfg, params = setup
    cfg0 = KGATConfig(ops_backend="ref",
                      mess_dropout=(0.0, 0.0, 0.0))  # drop randomness
    opt = optax.adam(1e-3)
    B = 32
    u = jnp.arange(B, dtype=jnp.int32) % meta.n_users
    ip = jnp.arange(B, dtype=jnp.int32) % meta.n_items
    ineg = (jnp.arange(B, dtype=jnp.int32) + 3) % meta.n_items
    w = jnp.ones(B)
    rng = jax.random.key(9)

    attention, _, make_cf_step, _ = make_partitioned(
        mesh, pg, info, meta, cfg0)
    _, ew_stack = attention(pg, params)
    step = make_cf_step(opt)
    p_p, _, loss_p = step(jax.tree.map(jnp.copy, params),
                          opt.init(params), ew_stack, u, ip, ineg, w, rng)

    att_s = kgat.compute_attention(params, g, cfg0)

    @jax.jit
    def single(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: kgat.cf_loss(p, g, att_s, meta, u, ip, ineg, cfg0,
                                   rng=rng, train=True,
                                   weight=w))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), loss

    p_s, loss_s = single(jax.tree.map(jnp.copy, params),
                         opt.init(params))

    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p_p["entity_embed"]),
                               np.asarray(p_s["entity_embed"]), atol=2e-5)


def test_ring_exchange_matches_single(setup):
    """The overlapped ring exchange (bucket reduces + ppermute) must
    reproduce single-device propagation and the per-step CF step
    bit-near-exactly — SURVEY §2.3 SP/CP row's named technique."""
    from kgat_tpu.parallel.partition import build_ring_buckets
    from kgat_tpu.graph import host_coo

    g, meta, mesh, pg, info, cfg, params = setup
    coo = host_coo(g)
    rb = build_ring_buckets(coo["src"], coo["dst"], info)

    att_s = kgat.compute_attention(params, g, cfg)
    emb_s = kgat.propagate(params, g, att_s, cfg)

    attention, propagate_eval, make_cf_step, _ = make_partitioned(
        mesh, pg, info, meta, cfg, exchange="ring", ring_buckets=rb)
    _, rw = attention(pg, params)
    emb_p = propagate_eval(rw, params)
    np.testing.assert_allclose(np.asarray(emb_p), np.asarray(emb_s),
                               rtol=1e-4, atol=1e-4)

    # CF step parity (dropout off for determinism).
    cfg0 = KGATConfig(ops_backend="ref", mess_dropout=(0.0, 0.0, 0.0))
    attention0, _, make_cf_step0, _ = make_partitioned(
        mesh, pg, info, meta, cfg0, exchange="ring", ring_buckets=rb)
    _, rw0 = attention0(pg, params)
    opt = optax.adam(1e-3)
    B = 32
    u = jnp.arange(B, dtype=jnp.int32) % meta.n_users
    ip = jnp.arange(B, dtype=jnp.int32) % meta.n_items
    ineg = (jnp.arange(B, dtype=jnp.int32) + 3) % meta.n_items
    w = jnp.ones(B)
    rng = jax.random.key(9)
    step = make_cf_step0(opt)
    p_p, _, loss_p = step(jax.tree.map(jnp.copy, params),
                          opt.init(params), rw0, u, ip, ineg, w, rng)

    att0 = kgat.compute_attention(params, g, cfg0)

    @jax.jit
    def single(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: kgat.cf_loss(p, g, att0, meta, u, ip, ineg, cfg0,
                                   rng=rng, train=True, weight=w))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), loss

    p_s, loss_s = single(jax.tree.map(jnp.copy, params), opt.init(params))
    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p_p["entity_embed"]),
                               np.asarray(p_s["entity_embed"]), atol=2e-5)


def test_partitioned_scan_matches_per_step(setup):
    """The device-resident chunked scan epoch (one compiled program) must
    reproduce the per-step partitioned path exactly (same key derivation:
    split(key) -> sample / dropout)."""
    g, meta, mesh, pg, info, _cfg, params = setup
    from kgat_tpu.sampler import CFSampleTable, sample_cf_batch

    ds = synthetic_dataset(seed=21, n_users=80, n_items=60, n_entities=120,
                           n_relations_kg=3, n_interactions=900,
                           n_triples=700)
    table = CFSampleTable.build(ds.cf_train, meta.n_users, meta.n_items)
    cfg0 = KGATConfig(ops_backend="ref", mess_dropout=(0.0, 0.0, 0.0))
    attention, _, make_cf_step, make_cf_scan = make_partitioned(
        mesh, pg, info, meta, cfg0)
    _, ew = attention(pg, params)
    opt = optax.adam(1e-3)
    B = 32
    keys = jax.random.split(jax.random.key(3), 2)

    scan = make_cf_scan(opt, table, B)  # pre-jitted (donation inside)
    p1, o1, s1 = scan(jax.tree.map(jnp.copy, params), opt.init(params),
                      ew, keys)

    step = make_cf_step(opt)
    p2, o2 = jax.tree.map(jnp.copy, params), opt.init(params)
    total = 0.0
    for k in keys:
        k_s, k_d = jax.random.split(k)
        u, ip, ineg, w = sample_cf_batch(table, k_s, B)
        p2, o2, l = step(p2, o2, ew, u, ip, ineg, w, k_d)
        total += float(l)

    np.testing.assert_allclose(float(s1), total, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p1["entity_embed"]),
                               np.asarray(p2["entity_embed"]), atol=2e-6)


@pytest.mark.parametrize("exchange", ["allgather", "ring", "a2a"],
                         ids=["allgather-ppermute", "ring-ppermute",
                              "a2a-ppermute"])
def test_partitioned_trainer_e2e(tmp_path, exchange):
    """Config 5's shape: multi-device trainer with edge-partitioned CF
    phase + DP KG phase, driven end-to-end for two epochs over each
    boundary exchange (the ring's chunk shifts are XLA ppermutes)."""
    from kgat_tpu.train import Trainer
    from kgat_tpu.utils.config import TrainConfig

    cfg = TrainConfig(
        dataset="synthetic", epochs=2, eval_every=2, lr=5e-3,
        cf_batch_size=64, kg_batch_size=64, n_devices=8, seed=5,
        halo_exchange=exchange,
        log_dir=str(tmp_path),
        syn_users=50, syn_items=40, syn_entities=80, syn_relations=3,
        syn_interactions=500, syn_triples=400,
        model=KGATConfig(aggregator="bi-interaction", conv_dims=(16, 8),
                         mess_dropout=(0.1, 0.1), embed_dim=16,
                         relation_dim=16, ops_backend="ref"),
    )
    tr = Trainer(cfg)
    assert tr.partitioned and tr.n_devices == 8
    cf1, kg1 = tr.train_one_epoch()
    cf2, kg2 = tr.train_one_epoch()
    assert np.isfinite([cf1, cf2, kg1, kg2]).all()
    assert cf2 < cf1 and kg2 < kg1
    m = tr.evaluate()
    assert 0 <= m["recall"] <= 1


def test_selective_halo_matches_single(setup):
    """The selective halo all-to-all (exchange='a2a') must reproduce
    single-device propagation and the CF step: activations live in a
    bounded local table (own + halo rows), never replicated — the path
    for embedding tables too large to replicate (SURVEY §2.3 SP/CP row,
    ROADMAP 'selective halo')."""
    from kgat_tpu.graph import host_coo
    from kgat_tpu.parallel.partition import build_selective_halo

    g, meta, mesh, pg, info, cfg, params = setup
    coo = host_coo(g)
    sh = build_selective_halo(coo["src"], coo["dst"], info)

    att_s = kgat.compute_attention(params, g, cfg)
    emb_s = kgat.propagate(params, g, att_s, cfg)

    attention, propagate_eval, make_cf_step, _ = make_partitioned(
        mesh, pg, info, meta, cfg, exchange="a2a", sel_halo=sh)
    _, sw = attention(pg, params)
    emb_p = propagate_eval(sw, params)
    np.testing.assert_allclose(np.asarray(emb_p), np.asarray(emb_s),
                               rtol=1e-4, atol=1e-4)

    # CF step parity (dropout off for determinism).
    cfg0 = KGATConfig(ops_backend="ref", mess_dropout=(0.0, 0.0, 0.0))
    attention0, _, make_cf_step0, _ = make_partitioned(
        mesh, pg, info, meta, cfg0, exchange="a2a", sel_halo=sh)
    _, sw0 = attention0(pg, params)
    opt = optax.adam(1e-3)
    B = 32
    u = jnp.arange(B, dtype=jnp.int32) % meta.n_users
    ip = jnp.arange(B, dtype=jnp.int32) % meta.n_items
    ineg = (jnp.arange(B, dtype=jnp.int32) + 3) % meta.n_items
    w = jnp.ones(B)
    rng = jax.random.key(9)
    step = make_cf_step0(opt)
    p_p, _, loss_p = step(jax.tree.map(jnp.copy, params),
                          opt.init(params), sw0, u, ip, ineg, w, rng)

    att0 = kgat.compute_attention(params, g, cfg0)

    @jax.jit
    def single(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: kgat.cf_loss(p, g, att0, meta, u, ip, ineg, cfg0,
                                   rng=rng, train=True, weight=w))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), loss

    p_s, loss_s = single(jax.tree.map(jnp.copy, params), opt.init(params))
    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p_p["entity_embed"]),
                               np.asarray(p_s["entity_embed"]), atol=2e-5)


def test_2d_mesh_dp_ep_matches_single(setup):
    """2D (dp, ep) mesh — the pod layout: each dp row holds a full edge
    partition (graph replicated across dp), CF batches shard over BOTH
    axes. The partitioned CF step must match the single-device update."""
    g, meta, _mesh8, _pg8, _info8, cfg, params = setup
    src = np.asarray(g.src)[: g.n_edges]
    dst = np.asarray(g.dst)[: g.n_edges]
    ety = np.asarray(g.etype)[: g.n_edges]
    mesh2d = jax.make_mesh((2, 4), ("dp", AXIS), axis_types=(jax.sharding.AxisType.Auto,) * 2)
    pg, info = partition_graph(src, dst, ety, meta.n_nodes,
                               meta.n_relations, 4)

    cfg0 = KGATConfig(ops_backend="ref", mess_dropout=(0.0, 0.0, 0.0))
    attention, propagate_eval, make_cf_step, _ = make_partitioned(
        mesh2d, pg, info, meta, cfg0, dp_axis="dp")
    _, ew = attention(pg, params)

    att_s = kgat.compute_attention(params, g, cfg0)
    emb_s = kgat.propagate(params, g, att_s, cfg0)
    emb_p = propagate_eval(ew, params)
    np.testing.assert_allclose(np.asarray(emb_p), np.asarray(emb_s),
                               rtol=1e-4, atol=1e-4)

    opt = optax.adam(1e-3)
    B = 32
    u = jnp.arange(B, dtype=jnp.int32) % meta.n_users
    ip = jnp.arange(B, dtype=jnp.int32) % meta.n_items
    ineg = (jnp.arange(B, dtype=jnp.int32) + 3) % meta.n_items
    w = jnp.ones(B)
    rng = jax.random.key(9)
    step = make_cf_step(opt)
    p_p, _, loss_p = step(jax.tree.map(jnp.copy, params),
                          opt.init(params), ew, u, ip, ineg, w, rng)

    @jax.jit
    def single(params, opt_state):
        loss, grads = jax.value_and_grad(
            lambda p: kgat.cf_loss(p, g, att_s, meta, u, ip, ineg, cfg0,
                                   rng=rng, train=True, weight=w))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), loss

    p_s, loss_s = single(jax.tree.map(jnp.copy, params), opt.init(params))
    np.testing.assert_allclose(float(loss_p), float(loss_s), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(p_p["entity_embed"]),
                               np.asarray(p_s["entity_embed"]), atol=2e-5)


def test_2d_mesh_trainer_e2e(tmp_path):
    """Trainer with --n-devices 8 --dp-replicas 2: 2x4 (dp, ep) mesh,
    two epochs end to end with decreasing losses."""
    from kgat_tpu.train import Trainer
    from kgat_tpu.utils.config import TrainConfig

    cfg = TrainConfig(
        dataset="synthetic", epochs=2, eval_every=2, lr=5e-3,
        cf_batch_size=64, kg_batch_size=64, n_devices=8, dp_replicas=2,
        seed=5, log_dir=str(tmp_path),
        syn_users=50, syn_items=40, syn_entities=80, syn_relations=3,
        syn_interactions=500, syn_triples=400,
        model=KGATConfig(aggregator="bi-interaction", conv_dims=(16, 8),
                         mess_dropout=(0.1, 0.1), embed_dim=16,
                         relation_dim=16, ops_backend="ref"),
    )
    tr = Trainer(cfg)
    assert tr.partitioned and tr.pinfo.n_parts == 4
    cf1, kg1 = tr.train_one_epoch()
    cf2, kg2 = tr.train_one_epoch()
    assert np.isfinite([cf1, cf2, kg1, kg2]).all()
    assert cf2 < cf1 and kg2 < kg1
    m = tr.evaluate()
    assert 0 <= m["recall"] <= 1
