"""Graph pytree construction invariants."""

import numpy as np

from kgat_tpu.data import synthetic_dataset
from kgat_tpu.graph import build_ckg, build_graph


def test_build_graph_dst_sorted_and_padded():
    src = np.array([3, 0, 2, 1, 0])
    dst = np.array([1, 2, 0, 0, 1])
    ety = np.array([0, 1, 1, 0, 2])
    g = build_graph(src, dst, ety, n_nodes=4, n_relations=3, edge_block=8)

    d = np.asarray(g.dst)
    assert g.n_edges == 5
    assert g.n_edges_pad % 8 == 0 and g.n_edges_pad > g.n_edges
    # dst-sorted reals, sentinel pads
    assert (np.diff(d[: g.n_edges]) >= 0).all()
    assert (d[g.n_edges:] == g.n_nodes).all()
    assert np.asarray(g.edge_mask).sum() == 5

    # CSR offsets delimit dst segments exactly
    ro = np.asarray(g.row_offsets)
    for v in range(g.n_nodes):
        seg = d[ro[v]: ro[v + 1]]
        assert (seg == v).all()
    assert ro[-1] == g.n_edges_pad

    # (src, dst, etype) multiset preserved
    got = sorted(zip(np.asarray(g.src)[:5].tolist(), d[:5].tolist(),
                     np.asarray(g.etype)[:5].tolist()))
    want = sorted(zip(src.tolist(), dst.tolist(), ety.tolist()))
    assert got == want


def test_rel_blocks_cover_all_edges_once():
    ds = synthetic_dataset(seed=3, n_users=20, n_items=15, n_entities=30,
                           n_relations_kg=3, n_interactions=100, n_triples=80)
    g, meta = ds.build()
    ag = np.asarray(g.att_gather)
    seen = []
    for (r, start, cnt, cnt_pad) in g.rel_blocks:
        blk = ag[start: start + cnt_pad]
        real, pad = blk[:cnt], blk[cnt:]
        assert (pad == g.n_edges).all()          # dead slot
        assert (np.asarray(g.etype)[real] == r).all()
        seen.extend(real.tolist())
    assert sorted(seen) == list(range(g.n_edges))


def test_ckg_conventions():
    cf = np.array([[0, 1], [1, 0]])       # users 0,1 ; items 1,0
    kg = np.array([[2, 0, 3], [1, 1, 4]])  # entities up to 5
    g, meta = build_ckg(cf, kg, n_users=2, n_entities=5, n_items=2,
                        n_relations_kg=2)
    assert meta.n_nodes == 7
    assert meta.n_relations == 6
    assert g.n_edges == 2 * len(kg) + 2 * len(cf)
    src = np.asarray(g.src)[: g.n_edges]
    dst = np.asarray(g.dst)[: g.n_edges]
    ety = np.asarray(g.etype)[: g.n_edges]
    edges = set(zip(src.tolist(), dst.tolist(), ety.tolist()))
    # triple (h=2, r=0, t=3): edge t->h and inverse h->t with r+R
    assert (3, 2, 0) in edges and (2, 3, 2) in edges
    # interaction (u=0 -> node 5, i=1): interact edge i->u, reverse u->i
    assert (1, 5, 4) in edges and (5, 1, 5) in edges


def test_graph_cache_roundtrip(tmp_path):
    """save_graph/load_graph + Dataset.build(cache_dir=...) must reproduce
    the built Graph exactly (arrays, layouts, statics, meta)."""
    import jax.numpy as jnp

    from kgat_tpu.graph import load_graph, save_graph

    ds = synthetic_dataset(seed=3, n_users=40, n_items=30, n_entities=60,
                           n_relations_kg=4, n_interactions=300,
                           n_triples=200)
    g, meta = ds.build()
    path = str(tmp_path / "g.npz")
    save_graph(path, g, meta)
    g2, meta2 = load_graph(path)
    assert meta2 == meta
    assert (g2.n_nodes, g2.n_edges, g2.n_edges_pad, g2.n_relations,
            g2.rel_blocks) == (g.n_nodes, g.n_edges, g.n_edges_pad,
                               g.n_relations, g.rel_blocks)
    for f in ("src", "dst", "etype", "edge_mask", "row_offsets",
              "att_gather", "rev_nbr", "rev_perm"):
        np.testing.assert_array_equal(np.asarray(getattr(g2, f)),
                                      np.asarray(getattr(g, f)), err_msg=f)
    for pre in ("fwd_pieces", "rev_pieces"):
        a, b = getattr(g, pre), getattr(g2, pre)
        for f in ("start", "length", "row"):
            np.testing.assert_array_equal(np.asarray(getattr(b, f)),
                                          np.asarray(getattr(a, f)),
                                          err_msg=f"{pre}.{f}")

    # Dataset.build cache: second call hits the cache (same object content),
    # and a changed dataset misses it (different hash -> rebuild).
    cache = str(tmp_path / "cache")
    g3, meta3 = ds.build(cache_dir=cache)
    g4, meta4 = ds.build(cache_dir=cache)  # cache hit
    assert meta3 == meta == meta4
    np.testing.assert_array_equal(np.asarray(g4.dst), np.asarray(g3.dst))
    import os
    files = os.listdir(cache)
    assert len(files) == 1
    ds2 = synthetic_dataset(seed=4, n_users=40, n_items=30, n_entities=60,
                            n_relations_kg=4, n_interactions=300,
                            n_triples=200)
    ds2.build(cache_dir=cache)
    assert len(os.listdir(cache)) == 2
