"""Reference-path ops vs dense numpy oracles (SURVEY.md §4 prescription 1).

Oracle: densify the graph into a weighted adjacency and do the obvious
dense thing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kgat_tpu.data import synthetic_dataset
from kgat_tpu.graph import build_graph
from kgat_tpu.ops import ref as ops


def _random_graph(rng, n_nodes=23, n_edges=140, n_rel=5):
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    ety = rng.integers(0, n_rel, n_edges)
    return build_graph(src, dst, ety, n_nodes, n_rel)


def _dense_adj(g, w):
    """Dense (n_nodes, n_nodes) matrix A with A[v, u] = sum of w over u->v."""
    A = np.zeros((g.n_nodes, g.n_nodes))
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    for e in range(g.n_edges):
        A[dst[e], src[e]] += w[e]
    return A


def test_spmm_matches_dense(rng):
    g = _random_graph(rng)
    w = rng.normal(size=g.n_edges_pad).astype(np.float32)
    x = rng.normal(size=(g.n_nodes, 16)).astype(np.float32)
    out = np.asarray(ops.spmm(g, jnp.asarray(w), jnp.asarray(x)))
    want = _dense_adj(g, w) @ x
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)


def test_spmm_grads(rng):
    g = _random_graph(rng, n_nodes=9, n_edges=30)
    w = jnp.asarray(rng.normal(size=g.n_edges_pad).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(g.n_nodes, 4)).astype(np.float32))
    # Finite-difference check: AD through gather+segment_sum must reproduce
    # DGL's dual-op rule (SpMM bwd == SDDMM on the reverse graph).
    from jax.test_util import check_grads
    check_grads(lambda w_, x_: jnp.sum(ops.spmm(g, w_, x_) ** 2), (w, x),
                order=1, modes=["rev"], atol=1e-2, rtol=1e-2)


def test_segment_softmax_matches_oracle(rng):
    g = _random_graph(rng)
    logits = rng.normal(size=g.n_edges_pad).astype(np.float32) * 3
    out = np.asarray(ops.segment_softmax(g, jnp.asarray(logits)))
    dst = np.asarray(g.dst)
    # Oracle: per-dst softmax over real edges.
    want = np.zeros_like(logits)
    for v in range(g.n_nodes):
        sel = np.where(dst[: g.n_edges] == v)[0]
        if len(sel) == 0:
            continue
        z = logits[sel] - logits[sel].max()
        e = np.exp(z)
        want[sel] = e / e.sum()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
    # Pads exactly zero; real segments sum to 1.
    assert (out[g.n_edges:] == 0).all()
    sums = np.zeros(g.n_nodes)
    np.add.at(sums, dst[: g.n_edges], out[: g.n_edges])
    present = np.unique(dst[: g.n_edges])
    np.testing.assert_allclose(sums[present], 1.0, atol=1e-5)


def test_segment_softmax_handwritten_orientation():
    """SURVEY.md hard-part #1: pin the normalization direction on a
    hand-computed 5-node example. Edges are stored t->h; softmax groups
    by dst == h (the head), i.e. over the triples *headed* by each node."""
    # head h=0 has three tails (1,2,3); head 4 has one tail (0).
    src = np.array([1, 2, 3, 0])
    dst = np.array([0, 0, 0, 4])
    ety = np.zeros(4, np.int64)
    g = build_graph(src, dst, ety, n_nodes=5, n_relations=1)
    logits = np.zeros(g.n_edges_pad, np.float32)
    logits[:4] = [np.log(1.0), np.log(2.0), np.log(5.0), 3.21]
    out = np.asarray(ops.segment_softmax(g, jnp.asarray(logits)))
    np.testing.assert_allclose(out[:3], [1 / 8, 2 / 8, 5 / 8], rtol=1e-6)
    np.testing.assert_allclose(out[3], 1.0, rtol=1e-6)


@pytest.mark.parametrize("msg", ["copy_u", "copy_e", "u_mul_e", "u_add_e",
                                 "u_sub_e", "u_div_e"])
@pytest.mark.parametrize("reduce", ["sum", "max", "min", "mean"])
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_gspmm_matches_oracle(rng, msg, reduce, backend):
    """DGL update_all(fn.<msg>, fn.<reduce>) surface vs a dense loop oracle
    (SURVEY.md §2.2 g-SpMM + segment-reduce rows)."""
    from kgat_tpu.ops import get_backend
    be = get_backend(backend)
    g = _random_graph(rng)
    d = 8
    x = rng.normal(size=(g.n_nodes, d)).astype(np.float32)
    w = rng.normal(size=g.n_edges_pad).astype(np.float32)
    if msg in ("copy_e", "u_add_e", "u_sub_e"):
        wv = rng.normal(size=(g.n_edges_pad, d)).astype(np.float32)
    elif msg == "u_div_e":
        wv = (0.5 + rng.random(g.n_edges_pad)).astype(np.float32)  # nonzero
    else:
        wv = w
    kw = {"interpret": True} if backend == "pallas" else {}
    out = np.asarray(be.gspmm(g, msg, reduce, jnp.asarray(x),
                              jnp.asarray(wv), **kw))
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    want = np.zeros((g.n_nodes, d) if out.ndim == 2 else (g.n_nodes,),
                    np.float32)
    for v in range(g.n_nodes):
        sel = np.where(dst[: g.n_edges] == v)[0]
        if len(sel) == 0:
            if reduce == "max":
                want[v] = np.finfo(np.float32).min
            elif reduce == "min":
                want[v] = np.finfo(np.float32).max
            continue
        if msg == "copy_u":
            m = x[src[sel]]
        elif msg == "copy_e":
            m = wv[sel]
        else:
            we = wv[sel] if wv.ndim == 2 else wv[sel][:, None]
            op = {"u_mul_e": np.multiply, "u_add_e": np.add,
                  "u_sub_e": np.subtract, "u_div_e": np.divide}[msg]
            m = op(x[src[sel]], we)
        rfn = {"sum": np.sum, "max": np.max, "min": np.min,
               "mean": np.mean}[reduce]
        want[v] = rfn(m, axis=0)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_segment_min_mean(rng, tiny_graph):
    g, _ = tiny_graph
    v = jnp.asarray(rng.normal(size=(g.n_edges_pad, 4)).astype(np.float32))
    s = np.asarray(ops.segment_sum(g, v))
    mean = np.asarray(ops.segment_mean(g, v))
    deg = np.zeros(g.n_nodes)
    np.add.at(deg, np.asarray(g.dst)[: g.n_edges], 1.0)
    np.testing.assert_allclose(
        mean, s / np.maximum(deg, 1.0)[:, None], rtol=1e-5, atol=1e-6)
    mn = np.asarray(ops.segment_min(
        g, jnp.where(jnp.asarray(g.edge_mask)[:, None] > 0, v,
                     jnp.finfo(jnp.float32).max)))
    assert mn.shape == (g.n_nodes, 4)


def test_sddmm_dot(rng):
    g = _random_graph(rng)
    a = rng.normal(size=(g.n_nodes, 8)).astype(np.float32)
    b = rng.normal(size=(g.n_nodes, 8)).astype(np.float32)
    out = np.asarray(ops.sddmm_dot(g, jnp.asarray(a), jnp.asarray(b)))
    src, dst = np.asarray(g.src), np.asarray(g.dst)
    for e in range(g.n_edges):
        np.testing.assert_allclose(out[e], a[src[e]] @ b[dst[e]],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "dot",
                                "copy_lhs", "copy_rhs"])
@pytest.mark.parametrize("targets", [("u", "v"), ("u", "e"), ("e", "v"),
                                     ("v", "u")])
def test_gsddmm_matches_oracle(rng, op, targets):
    """DGL apply_edges(fn.<op>) surface vs a per-edge loop oracle
    (SURVEY.md §2.2 g-SDDMM row)."""
    g = _random_graph(rng)
    lt, rt = targets
    d = 6

    def operand(t):
        n = g.n_nodes if t in ("u", "v") else g.n_edges_pad
        a = rng.normal(size=(n, d)).astype(np.float32)
        return a + 2.0 if op == "div" else a  # keep divisors away from 0

    lhs, rhs = operand(lt), operand(rt)
    out = np.asarray(ops.gsddmm(g, op, jnp.asarray(lhs), jnp.asarray(rhs),
                                lhs_target=lt, rhs_target=rt))
    src, dst = np.asarray(g.src), np.asarray(g.dst)

    def at(val, t, e):
        return val[src[e]] if t == "u" else (
            val[dst[e]] if t == "v" else val[e])

    for e in range(g.n_edges):
        a, b = at(lhs, lt, e), at(rhs, rt, e)
        want = {"add": a + b, "sub": a - b, "mul": a * b, "div": a / b,
                "dot": np.sum(a * b), "copy_lhs": a, "copy_rhs": b}[op]
        np.testing.assert_allclose(out[e], want, rtol=1e-5, atol=1e-5)
