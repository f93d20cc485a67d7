"""`pallas` ops backend: a CSR SpMM kernel for the GPU (Pallas on Triton).

The SpMM ``out[v] = sum_{(u -> v)} w_e * x[u]`` is the hot loop of KGAT
training: every CF step runs it forward and backward once per layer over
the whole CKG. It is a weighted row gather with no data reuse beyond the
feature table, so it is bound by memory traffic, not arithmetic. XLA's
plain version (``ops.ref.spmm``) materialises the (E, d) message array and
scatter-adds it; this kernel reads each source row straight into registers
and accumulates in float32, writing only per-piece partial sums.

Work split: the graph cuts every CSR row into pieces of at most
``graph.PIECE_EDGES`` positions (:class:`kgat_tpu.graph.RowPieces`). One
kernel program owns ``BLOCK_PIECES`` consecutive pieces, one per tile row;
step ``k`` of its loop gathers position ``k`` of every piece at once, so a
hub row spreads over many lanes and programs instead of serializing one.
The pieces' partial sums are added per row by a sorted ``segment_sum`` over
the (few) pieces — no atomics, no per-edge message array.

Autograd mirrors DGL's dual-op structure (SURVEY.md §2.2 autograd row): the
feature gradient is the same kernel on the REVERSE graph (the src-sorted
view the Graph carries), the weight gradient a per-edge row dot (SDDMM).

The kernel is compiled for the GPU; ``interpret=True`` runs it in the
Pallas interpreter instead, which is how the CPU tests exercise it.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from kgat_tpu.graph import Graph, RowPieces
from kgat_tpu.ops import ref as _ref

# Scalar-wise ops: reference path (cheap relative to the SpMM).
segment_softmax = _ref.segment_softmax
sddmm_dot = _ref.sddmm_dot
segment_sum = _ref.segment_sum
segment_max = _ref.segment_max
segment_min = _ref.segment_min
segment_mean = _ref.segment_mean

# Pieces per kernel program (the tile is (BLOCK_PIECES, d) float32) and
# warps per program: the fastest pair measured on an H100 at yelp scale for
# d = 64 and 32 (PERF.md).
BLOCK_PIECES = 32
NUM_WARPS = 8


def _feature_width(d: int) -> int:
    """Kernel tile width for feature dim d: Triton tiles are powers of 2."""
    return max(16, 1 << (d - 1).bit_length())


def _spmm_kernel(start_ref, length_ref, nbr_ref, w_ref, x_ref, out_ref):
    start = start_ref[...]
    length = length_ref[...]
    bp, d = out_ref.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (bp, d), 1)

    def step(k, acc):
        live = k < length
        pos = start + k
        nbr = plgpu.load(nbr_ref.at[pos], mask=live, other=0)
        w = plgpu.load(w_ref.at[pos], mask=live, other=0)
        rows = jnp.broadcast_to(nbr[:, None], (bp, d))
        xg = plgpu.load(x_ref.at[rows, col], mask=live[:, None], other=0)
        return acc + w.astype(jnp.float32)[:, None] * xg.astype(jnp.float32)

    out_ref[...] = jax.lax.fori_loop(0, jnp.max(length), step,
                                     jnp.zeros((bp, d), jnp.float32))


def csr_reduce(pieces: RowPieces, nbr: jax.Array, w: jax.Array,
               x: jax.Array, n_out: int, *, interpret: bool = False
               ) -> jax.Array:
    """out[r] = sum over CSR positions p of row r: w[p] * x[nbr[p]].

    Returns (n_out, d) float32. x may be bf16 (gathered at half the bytes,
    accumulated in float32). Rows without pieces are zero; pieces whose
    row is >= n_out are dropped.
    """
    n, d = x.shape
    v = pieces.start.shape[0]
    if v == 0:
        return jnp.zeros((n_out, d), jnp.float32)
    dp = _feature_width(d)
    if dp != d:
        x = jnp.pad(x, ((0, 0), (0, dp - d)))
    vp = -(-v // BLOCK_PIECES) * BLOCK_PIECES
    start = jnp.pad(pieces.start, (0, vp - v))
    length = jnp.pad(pieces.length, (0, vp - v))
    vec = pl.BlockSpec((BLOCK_PIECES,), lambda i: (i,))
    partial = pl.pallas_call(
        _spmm_kernel,
        grid=(vp // BLOCK_PIECES,),
        in_specs=[vec, vec, pl.no_block_spec, pl.no_block_spec,
                  pl.no_block_spec],
        out_specs=pl.BlockSpec((BLOCK_PIECES, dp), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((vp, dp), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="csr_spmm",
    )(start, length, nbr, w, x)
    out = jax.ops.segment_sum(partial[:v], pieces.row, num_segments=n_out,
                              indices_are_sorted=True)
    return out[:, :d]


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _spmm_p(static, w_fwd, w_rev, x, fwd_pieces, fwd_nbr, fwd_rows,
            rev_pieces, rev_nbr):
    n_fwd, _n_rev, interpret = static
    return csr_reduce(fwd_pieces, fwd_nbr, w_fwd, x, n_fwd,
                      interpret=interpret)


def _spmm_fwd(static, w_fwd, w_rev, x, fwd_pieces, fwd_nbr, fwd_rows,
              rev_pieces, rev_nbr):
    out = _spmm_p(static, w_fwd, w_rev, x, fwd_pieces, fwd_nbr, fwd_rows,
                  rev_pieces, rev_nbr)
    return out, (w_fwd, w_rev, x, fwd_nbr, fwd_rows, rev_pieces, rev_nbr)


def _spmm_bwd(static, res, g):
    n_fwd, n_rev, interpret = static
    w_fwd, w_rev, x, fwd_nbr, fwd_rows, rev_pieces, rev_nbr = res
    # dL/dw[p] = <x[nbr_p], g[row_p]> — the SDDMM dual. (XLA drops this
    # branch when the weights are stop-gradient, the training case:
    # attention is cached per epoch.)
    d_w = jnp.sum(x[fwd_nbr].astype(jnp.float32)
                  * g[jnp.clip(fwd_rows, 0, n_fwd - 1)], axis=-1)
    # dL/dx[u] = sum over edges with src == u of w_e * g[dst_e] — the
    # same kernel on the reverse graph, streaming g at x's dtype.
    d_x = csr_reduce(rev_pieces, rev_nbr, w_rev, g.astype(x.dtype), n_rev,
                     interpret=interpret)
    return (d_w.astype(w_fwd.dtype), jnp.zeros_like(w_rev),
            d_x.astype(x.dtype), None, None, None, None, None)


_spmm_p.defvjp(_spmm_fwd, _spmm_bwd)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EdgeWeights:
    """Masked edge weights staged for both SpMM directions: canonical
    (dst-sorted) order and reverse (src-sorted) order. Attention weights
    change once per epoch (SURVEY.md §3.1), so the trainer stages them once
    with :func:`prepare_weights` and every CF step reuses both vectors."""

    fwd: jax.Array   # (E_pad,) w * mask, canonical order
    rev: jax.Array   # (E_pad,) fwd[graph.rev_perm]


def prepare_weights(graph: Graph, edge_w: jax.Array) -> EdgeWeights:
    fwd = edge_w * graph.edge_mask
    return EdgeWeights(fwd=fwd, rev=fwd[graph.rev_perm])


def spmm_pieces(ew: EdgeWeights, x: jax.Array, fwd_pieces: RowPieces,
                fwd_nbr: jax.Array, fwd_rows: jax.Array, n_fwd: int,
                rev_pieces: RowPieces, rev_nbr: jax.Array, n_rev: int,
                *, interpret: bool = False) -> jax.Array:
    """Differentiable SpMM over explicit CSR pieces (the partitioned path
    passes a shard's local view): (n_fwd, d) float32."""
    return _spmm_p((n_fwd, n_rev, interpret), ew.fwd, ew.rev, x,
                   fwd_pieces, fwd_nbr, fwd_rows, rev_pieces, rev_nbr)


def spmm(graph: Graph, edge_w, x: jax.Array, *, interpret: bool = False
         ) -> jax.Array:
    """out[v] = sum over edges (u -> v) of edge_w[e] * x[u], float32.

    ``edge_w`` is either canonical (E_pad,) weights or prepared
    :class:`EdgeWeights` (preferred in hot loops).
    """
    ew = edge_w if isinstance(edge_w, EdgeWeights) \
        else prepare_weights(graph, edge_w)
    return spmm_pieces(ew, x, graph.fwd_pieces, graph.src, graph.dst,
                       graph.n_nodes, graph.rev_pieces, graph.rev_nbr,
                       graph.n_nodes, interpret=interpret)


def gspmm(graph: Graph, msg: str, reduce: str, x=None, edge_w=None, *,
          interpret: bool = False):
    """Generalized g-SpMM (DGL update_all surface) on the pallas backend.

    The weighted-sum/mean cases with scalar edge weights — the
    bandwidth-bound ones — run the CSR kernel; mean divides the kernel's
    sum by the real in-degree (DGL semantics). Min/max and feature-valued
    edge data take the XLA path (not on any hot path).
    """
    if (msg == "u_mul_e" and reduce in ("sum", "mean")
            and edge_w is not None and edge_w.ndim == 1):
        s = spmm(graph, edge_w, x, interpret=interpret).astype(x.dtype)
        if reduce == "sum":
            return s
        deg = _ref.segment_sum(graph, graph.edge_mask)
        return s / jnp.maximum(deg, 1.0)[:, None]
    if msg == "copy_u" and reduce in ("sum", "mean"):
        ones = jnp.ones((graph.n_edges_pad,), x.dtype)
        return gspmm(graph, "u_mul_e", reduce, x, ones, interpret=interpret)
    return _ref.gspmm(graph, msg, reduce, x, edge_w)
