"""The CSR SpMM kernel (ops/pallas_backend.py) vs the XLA reference path
(SURVEY.md §4: same test runs on both backends, like DGL's
backend-parametrized fixtures). On the CPU the kernel runs in the Pallas
interpreter; tests marked ``gpu`` compile it for the card and skip
elsewhere (chip_smoke.py runs them on the GPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kgat_tpu.data import synthetic_dataset
from kgat_tpu.graph import PIECE_EDGES, build_graph, row_pieces
from kgat_tpu.models import kgat
from kgat_tpu.models.kgat import KGATConfig
from kgat_tpu.ops import get_backend, resolve_backend
from kgat_tpu.ops import pallas_backend as pb
from kgat_tpu.ops import ref as ref_ops


@pytest.fixture(scope="module")
def graph_meta():
    ds = synthetic_dataset(seed=11, n_users=60, n_items=40, n_entities=90,
                           n_relations_kg=4, n_interactions=700,
                           n_triples=500)
    return ds.build()


def _hub_graph():
    """One destination row with more edges than a kernel program covers
    (BLOCK_PIECES pieces of PIECE_EDGES), plus a light random tail."""
    rng = np.random.default_rng(3)
    n, hub = 300, pb.BLOCK_PIECES * PIECE_EDGES + 321
    dst = np.concatenate([np.full(hub, 7), rng.integers(0, n, 900)])
    src = rng.integers(0, n, len(dst))
    return build_graph(src, dst, np.zeros(len(dst), np.int64), n, 1)


def _sparse_graph():
    """Most rows empty (no in-edges and no out-edges), many pad edges."""
    rng = np.random.default_rng(4)
    n = 500
    dst = rng.integers(0, 40, 150) * 7
    src = rng.integers(0, 60, 150) * 3
    return build_graph(src, dst, np.zeros(150, np.int64), n, 1,
                       force_edge_pad=4096)


@functools.cache
def _graph(name):
    if name == "ckg":
        return synthetic_dataset(seed=5, n_users=40, n_items=30,
                                 n_entities=60, n_relations_kg=3,
                                 n_interactions=400,
                                 n_triples=300).build()[0]
    return _hub_graph() if name == "hub" else _sparse_graph()


@pytest.mark.parametrize("graph", ["ckg", "hub", "sparse"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_csr_kernel_matches_ref(graph, dtype, d):
    """Kernel (interpreted) == ref.spmm on the same (rounded) inputs. bf16
    features are compared against the reference on the bf16-rounded
    values, so both sides differ only in float32 summation order."""
    g = _graph(graph)
    rng = np.random.default_rng(d)
    w = jnp.asarray(rng.uniform(size=g.n_edges_pad).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(g.n_nodes, d)).astype(np.float32))
    if dtype == "bf16":
        x = x.astype(jnp.bfloat16)
    got = pb.spmm(g, w, x, interpret=True)
    assert got.shape == (g.n_nodes, d) and got.dtype == jnp.float32
    want = ref_ops.spmm(g, w, x.astype(jnp.float32))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("graph", ["ckg", "hub", "sparse"])
def test_csr_kernel_vjp_matches_ref(graph):
    """d/dx (the kernel on the reverse graph) and d/dw (the row dot) ==
    jax.grad of the reference."""
    g = _graph(graph)
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.uniform(size=g.n_edges_pad).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(g.n_nodes, 32)).astype(np.float32))
    cot = jnp.asarray(rng.normal(size=(g.n_nodes, 32)).astype(np.float32))

    def loss(f):
        return lambda w_, x_: jnp.vdot(f(w_, x_), cot)

    dw_p, dx_p = jax.grad(loss(lambda w_, x_: pb.spmm(
        g, w_, x_, interpret=True)), argnums=(0, 1))(w, x)
    dw_r, dx_r = jax.grad(loss(lambda w_, x_: ref_ops.spmm(g, w_, x_)),
                          argnums=(0, 1))(w, x)
    np.testing.assert_allclose(np.asarray(dx_p), np.asarray(dx_r),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dw_p), np.asarray(dw_r),
                               rtol=1e-5, atol=1e-4)


def test_row_pieces_cover_every_position_once():
    offsets = np.array([0, 0, 3, 3, 3 + 2 * PIECE_EDGES + 5, 200, 200])
    p = row_pieces(offsets)
    assert (p["length"] > 0).all() and (p["length"] <= PIECE_EDGES).all()
    assert (np.diff(p["row"]) >= 0).all()
    covered = np.concatenate([np.arange(s, s + n) for s, n in
                              zip(p["start"], p["length"])])
    np.testing.assert_array_equal(covered, np.arange(200))
    rows = np.repeat(p["row"], p["length"])
    np.testing.assert_array_equal(
        rows, np.repeat(np.arange(6), np.diff(offsets)))


def test_backend_follows_platform(monkeypatch):
    """No user flag: the kernel on the GPU, the reference elsewhere."""
    assert resolve_backend() == "ref"        # the CPU test platform
    assert get_backend() is ref_ops
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert resolve_backend() == "pallas"
    assert get_backend() is pb
    assert resolve_backend("ref") == "ref"   # tests may still pin one
    with pytest.raises(ValueError):
        resolve_backend("cuda")


def test_pallas_spmm_matches_ref(graph_meta, rng):
    g, meta = graph_meta
    w = jnp.asarray(rng.normal(size=g.n_edges_pad).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(g.n_nodes, 64)).astype(np.float32))
    got = pb.spmm(g, w, x, interpret=True)
    want = ref_ops.spmm(g, w, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def test_pallas_spmm_grads_match_ref(graph_meta, rng):
    g, meta = graph_meta
    w = jnp.asarray(rng.normal(size=g.n_edges_pad).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(g.n_nodes, 32)).astype(np.float32))
    cot = jnp.asarray(rng.normal(size=(g.n_nodes, 32)).astype(np.float32))

    def loss(f):
        return lambda w_, x_: jnp.vdot(f(g, w_, x_), cot)

    dw_p, dx_p = jax.grad(loss(lambda g_, w_, x_: pb.spmm(
        g_, w_, x_, interpret=True)), argnums=(0, 1))(w, x)
    dw_r, dx_r = jax.grad(loss(ref_ops.spmm), argnums=(0, 1))(w, x)
    np.testing.assert_allclose(np.asarray(dw_p), np.asarray(dw_r),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dx_p), np.asarray(dx_r),
                               rtol=1e-4, atol=1e-4)


def test_pallas_full_model_parity(graph_meta):
    """Whole forward path (attention -> propagate -> scores) on both
    backends must agree (activation parity, SURVEY.md §4.2)."""
    g, meta = graph_meta
    u = jnp.arange(8)
    it = jnp.arange(8)
    outs = {}
    for backend in ["ref", "pallas"]:
        cfg = KGATConfig(ops_backend=backend, interpret=True)
        params = kgat.init_params(jax.random.key(5), meta.n_nodes,
                                  meta.n_relations, cfg)
        att = kgat.attention_for_training(params, g, cfg)
        emb = kgat.propagate(params, g, att, cfg)
        outs[backend] = np.asarray(kgat.cf_scores(emb, meta, u, it))
    np.testing.assert_allclose(outs["pallas"], outs["ref"],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_csr_kernel_compiled_on_card(dtype):
    """The kernel as compiled for the card, forward and VJP, against the
    reference at highest matmul precision (chip_smoke.py runs this)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: the compiled kernel has no CPU "
                    "lowering (the interpreted kernel is tested above)")
    g = _graph("hub")
    rng = np.random.default_rng(2)
    w = jnp.asarray(rng.uniform(size=g.n_edges_pad).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(g.n_nodes, 64)).astype(np.float32))
    if dtype == "bf16":
        x = x.astype(jnp.bfloat16)
    xf = x.astype(jnp.float32)
    cot = jnp.asarray(rng.normal(size=(g.n_nodes, 64)).astype(np.float32))
    got, vjp = jax.vjp(lambda x_: pb.spmm(g, w, x_), x)
    with jax.default_matmul_precision("highest"):
        want, vjp_r = jax.vjp(lambda x_: ref_ops.spmm(g, w, x_), xf)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
    (dx,), (dx_r,) = vjp(cot), vjp_r(cot)
    # bf16 streams the cotangent at bf16: an 8-bit mantissa on its inputs.
    tol = 1e-4 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(np.asarray(dx, np.float32), np.asarray(dx_r),
                               rtol=tol, atol=tol * 10)
