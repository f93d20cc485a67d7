"""Reference (pure-XLA) message-passing ops.

These are the semantics oracle for the GPU SpMM kernel and the CPU/debug
path. Each op mirrors one native DGL component (SURVEY.md §2.2):

  spmm            <- g-SpMM: `update_all(fn.u_mul_e('h','w','m'), fn.sum)`
                     (DGL src/array/{cpu,cuda}/spmm.*, reconstructed)
  sddmm_dot       <- g-SDDMM: per-edge dot of endpoint features
                     (DGL src/array/{cpu,cuda}/sddmm.*, reconstructed)
  segment_softmax <- dgl.ops.edge_softmax (per-dst segment softmax)
  segment_sum/max <- DGL segment-reduce kernels

All ops take the padded dst-sorted :class:`kgat_tpu.graph.Graph`; pad edges
(dst == n_nodes) land in the sentinel segment and are masked out. Autograd
is ordinary JAX AD through gather/segment_sum, which reproduces DGL's
"SpMM backward = SDDMM on the reverse graph" rule automatically.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from kgat_tpu.graph import Graph


def segment_sum(graph: Graph, edge_vals: jax.Array) -> jax.Array:
    """Sum edge values into their dst segments. Returns (n_nodes, ...)."""
    out = jax.ops.segment_sum(
        edge_vals, graph.dst, num_segments=graph.num_segments,
        indices_are_sorted=True,
    )
    return out[: graph.n_nodes]

def segment_max(graph: Graph, edge_vals: jax.Array) -> jax.Array:
    """Max of edge values per dst segment (-inf for empty segments)."""
    out = jax.ops.segment_max(
        edge_vals, graph.dst, num_segments=graph.num_segments,
        indices_are_sorted=True,
    )
    return out[: graph.n_nodes]


def segment_min(graph: Graph, edge_vals: jax.Array) -> jax.Array:
    """Min of edge values per dst segment (+inf for empty segments)."""
    out = jax.ops.segment_min(
        edge_vals, graph.dst, num_segments=graph.num_segments,
        indices_are_sorted=True,
    )
    return out[: graph.n_nodes]


def segment_mean(graph: Graph, edge_vals: jax.Array) -> jax.Array:
    """Mean of edge values per dst segment (0 for empty segments).

    DGL segment-reduce 'mean' semantics: sum / in-degree, counting only
    real (non-pad) edges.
    """
    s = segment_sum(graph, edge_vals)
    deg = jax.ops.segment_sum(
        graph.edge_mask, graph.dst, num_segments=graph.num_segments,
        indices_are_sorted=True,
    )[: graph.n_nodes]
    deg = jnp.maximum(deg, 1.0)
    return s / deg.reshape((-1,) + (1,) * (edge_vals.ndim - 1))


def spmm(graph: Graph, edge_w: jax.Array, x: jax.Array) -> jax.Array:
    """out[v] = sum over edges (u -> v) of edge_w[e] * x[u].

    edge_w: (E_pad,) per-edge scalar weight (attention); x: (n_nodes, d).
    Pad edges contribute to the dropped sentinel segment only, but we mask
    the weight anyway so NaN/Inf in pad slots can never propagate.
    """
    w = edge_w * graph.edge_mask
    msgs = x[graph.src] * w[:, None]
    return segment_sum(graph, msgs)


MSG_OPS = ("copy_u", "copy_e", "u_mul_e", "u_add_e", "u_sub_e", "u_div_e")
REDUCE_OPS = ("sum", "max", "min", "mean")


def gspmm(graph: Graph, msg: str, reduce: str, x=None, edge_w=None
          ) -> jax.Array:
    """Generalized g-SpMM: DGL's `update_all(fn.<msg>, fn.<reduce>)` surface
    (SURVEY.md §2.2 g-SpMM row; DGL python/dgl/ops/spmm.py, reconstructed).

    msg in {copy_u, copy_e, u_{mul,add,sub,div}_e}; reduce in
    {sum, max, min, mean}. x: (n_nodes, d) node features (required unless
    msg == copy_e); edge_w: (E_pad,) or (E_pad, d) edge data (required
    unless msg == copy_u). Returns (n_nodes, d) (or (n_nodes,) for scalar
    messages). Pad edges never contribute.
    """
    if msg not in MSG_OPS:
        raise ValueError(f"msg {msg!r} not in {MSG_OPS}")
    if reduce not in REDUCE_OPS:
        raise ValueError(f"reduce {reduce!r} not in {REDUCE_OPS}")
    if msg == "copy_u":
        m = x[graph.src]
    elif msg == "copy_e":
        m = edge_w
    else:
        u = x[graph.src]
        w = edge_w if edge_w.ndim == u.ndim else edge_w[:, None]
        m = _BINOPS[msg[2:-2]](u, w)
    if reduce in ("sum", "mean"):
        # zero masked edges so pad slots can't poison sums
        mask = graph.edge_mask.reshape((-1,) + (1,) * (m.ndim - 1))
        m = m * mask
        return segment_sum(graph, m) if reduce == "sum" \
            else segment_mean(graph, m)
    fill = jnp.finfo(m.dtype).min if reduce == "max" \
        else jnp.finfo(m.dtype).max
    mask = (graph.edge_mask > 0).reshape((-1,) + (1,) * (m.ndim - 1))
    m = jnp.where(mask, m, fill)
    return segment_max(graph, m) if reduce == "max" \
        else segment_min(graph, m)


_BINOPS = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "dot": lambda a, b: jnp.sum(a * b, axis=-1),
}

SDDMM_TARGETS = ("u", "v", "e")


def gsddmm(graph: Graph, op: str, lhs: jax.Array, rhs: jax.Array,
           lhs_target: str = "u", rhs_target: str = "v") -> jax.Array:
    """Generalized g-SDDMM: DGL's `apply_edges(fn.<op>)` surface
    (SURVEY.md §2.2 g-SDDMM row; DGL python/dgl/ops/sddmm.py,
    reconstructed): per-edge `op(lhs, rhs)` where each operand lives on
    the edge's source node (``u``), destination node (``v``), or the edge
    itself (``e``).

    op in {add, sub, mul, div, dot, copy_lhs, copy_rhs}; node operands are
    (n_nodes, ...), edge operands (E_pad, ...). Returns (E_pad, ...)
    ((E_pad,) for dot). Pad-edge slots hold garbage from the clamped
    sentinel gather — downstream reducers mask by graph.edge_mask, same
    contract as sddmm_dot / attention logits.
    """
    def fetch(val, target):
        if target not in SDDMM_TARGETS:
            raise ValueError(f"target {target!r} not in {SDDMM_TARGETS}")
        if target == "u":
            return val[graph.src]
        if target == "v":
            # Clamp the sentinel dst (n_nodes); pads are masked downstream.
            return val[jnp.minimum(graph.dst, graph.n_nodes - 1)]
        return val
    if op == "copy_lhs":
        return fetch(lhs, lhs_target)
    if op == "copy_rhs":
        return fetch(rhs, rhs_target)
    if op not in _BINOPS:
        raise ValueError(f"op {op!r} not in {tuple(_BINOPS)} + copy_*")
    return _BINOPS[op](fetch(lhs, lhs_target), fetch(rhs, rhs_target))


def sddmm_dot(graph: Graph, a: jax.Array, b: jax.Array) -> jax.Array:
    """Per-edge dot product: out[e] = <a[src_e], b[dst_e]>. (E_pad,)."""
    # Clamp the sentinel dst (n_nodes) gather; result is masked by callers.
    dst = jnp.minimum(graph.dst, graph.n_nodes - 1)
    return jnp.sum(a[graph.src] * b[dst], axis=-1)


def segment_softmax(graph: Graph, logits: jax.Array) -> jax.Array:
    """Per-dst-segment softmax over edge logits, pad edges -> 0.

    Matches dgl.ops.edge_softmax semantics: subtract the segment max, exp,
    divide by the segment sum (SURVEY.md §2.2 edge_softmax row).
    """
    neg = jnp.finfo(logits.dtype).min
    masked = jnp.where(graph.edge_mask > 0, logits, neg)
    maxes = jax.ops.segment_max(
        masked, graph.dst, num_segments=graph.num_segments,
        indices_are_sorted=True,
    )
    # Empty segments produce -inf/min; clamp so the broadcast stays finite.
    maxes = jnp.maximum(maxes, neg)
    shifted = jnp.exp(masked - maxes[graph.dst]) * graph.edge_mask
    denom = jax.ops.segment_sum(
        shifted, graph.dst, num_segments=graph.num_segments,
        indices_are_sorted=True,
    )
    denom = jnp.where(denom > 0, denom, 1.0)
    return shifted / denom[graph.dst]
