"""Edge partitioning of the CKG across a device mesh.

The north-star's centerpiece (BASELINE.json:5, SURVEY.md §2.3 SP/CP row):
shard the collaborative knowledge graph's EDGES across chips so attention
recompute and propagation scale in edges/s. Strategy: **1D destination
partition** — each device owns a contiguous block of destination rows and
every edge pointing into them. Consequences (why dst, not src or 2D):

* Edge-softmax normalizes per destination (SURVEY.md §2.8 A5), so the
  entire attention recompute — SDDMM + softmax — is embarrassingly
  parallel: no communication at all.
* The SpMM segment-reduce is local per device (its output rows are owned);
  the only forward communication is obtaining source-node embeddings,
  which ride an all-gather per layer (selective halo all-to-all
  is the planned refinement when tables outgrow replication).
* SpMM backward's feature gradient lands on arbitrary source rows; the
  shard_map transpose of the all-gather is exactly the reduce-scatter /
  psum that sums the per-device partials.

All shards share one SPMD program: padded shapes and static metadata are
forced uniform (max across shards) via build_graph's force_* parameters.
The per-shard Graphs are stacked leaf-wise into a single Graph pytree whose
arrays carry a leading 'ep' axis.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from kgat_tpu.graph import (ALIGN_BLOCK_ROWS, ALIGN_CHUNK_EDGES, Graph,
                            build_graph, _round_up)


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    n_parts: int
    rows_per_part: int       # multiple of 128; device p owns rows [p*R, (p+1)*R)
    n_nodes_global: int
    n_nodes_pad: int         # rows_per_part * n_parts


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RingBuckets:
    """Per-shard edge buckets in RING-STEP order for the overlapped exchange.

    The SP/CP ring-attention analog for graphs (SURVEY.md §2.3 SP/CP
    row): each device's edges are bucketed by the
    *source partition block*; at ring step ``s`` device ``p`` holds the
    embedding chunk of partition ``(p - s) mod P`` and reduces exactly the
    bucket stored at index ``s`` — a static index, so the whole ring is a
    statically unrolled loop of (bucket reduce, ppermute) pairs that XLA
    overlaps (the permute of the next chunk is in flight while the current
    bucket computes).

    ``fwd``/``rev`` are AlignedLayouts whose array leaves carry a leading
    (P,) ring-step axis; fwd segments are LOCAL dst rows (0..R), fwd node
    ids are LOCAL rows of the in-flight chunk; rev segments are local rows
    of the chunk (grad destination), rev node ids are local dst rows.
    ``gather`` maps bucket-aligned positions -> the shard's canonical edge
    slots (for attention-weight staging).
    """

    fwd: "AlignedLayout"
    rev: "AlignedLayout"


def _needed_chunks(seg: np.ndarray, n_rows: int,
                   chunk: int = ALIGN_CHUNK_EDGES) -> int:
    """Chunks an AlignedLayout will need for these segment ids."""
    if len(seg) == 0:
        return 0
    blk = np.bincount(seg // ALIGN_BLOCK_ROWS,
                      minlength=-(-n_rows // ALIGN_BLOCK_ROWS))
    return int(np.sum(-(-blk // chunk)))



def _stack_axis(mesh) -> str:
    """Mesh axis to stack shards over: the edge-partition axis ('ep')
    when present (2D (dp, ep) meshes replicate across the rest)."""
    return "ep" if "ep" in mesh.axis_names else mesh.axis_names[0]

# Ring buckets hold ~E/P^2 edges each; a small chunk keeps their padding
# (<= n_dst_blocks * chunk dead slots per bucket) proportionate.
RING_CHUNK_EDGES = 256


def _remap_gather(layout, ids: np.ndarray, dead_slot: int):
    """Rebase a subset-built AlignedLayout's gather onto canonical slots."""
    import dataclasses as _dc

    from kgat_tpu.graph import host_array
    g = host_array(layout, "gather")
    n_sub = len(ids)
    if n_sub == 0:
        g2 = np.full(g.shape, dead_slot, np.int32)
    else:
        g2 = np.where(g < n_sub, ids[np.minimum(g, n_sub - 1)],
                      dead_slot).astype(np.int32)
    new = _dc.replace(layout, gather=jnp.asarray(g2))
    object.__setattr__(new, "_host", {**layout._host, "gather": g2})
    return new


def build_ring_buckets(src: np.ndarray, dst: np.ndarray,
                       info: PartitionInfo, mesh=None) -> RingBuckets:
    """Build the ring-step-ordered edge buckets for every shard.

    Returns a RingBuckets whose layout leaves have shape (P, P, ...):
    leading shard axis (sharded over the mesh), then the ring-step axis
    (statically indexed by the unrolled ring loop). Must be called with the
    same (src, dst) arrays as :func:`partition_graph` — bucket gathers
    index each shard's canonical (local-dst stable sorted) edge slots.
    """
    from kgat_tpu.graph import _build_aligned_layout, _stable_sort_perm

    P, R = info.n_parts, info.rows_per_part
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)

    shard_edges = []
    fwd_need, rev_need = 1, 1
    for p in range(P):
        sel = (dst >= p * R) & (dst < (p + 1) * R)
        s_src, s_dst = src[sel], dst[sel] - p * R
        order = _stable_sort_perm(s_dst, R)
        s_src, s_dst = s_src[order], s_dst[order]   # shard-canonical order
        shard_edges.append((s_src, s_dst))
        for s in range(P):
            q = (p - s) % P
            m = (s_src // R) == q
            fwd_need = max(fwd_need,
                           _needed_chunks(s_dst[m], R, RING_CHUNK_EDGES))
            rev_need = max(rev_need,
                           _needed_chunks(s_src[m] - q * R, R,
                                          RING_CHUNK_EDGES))

    per_shard = []
    for p in range(P):
        s_src, s_dst = shard_edges[p]
        n_e = len(s_src)
        dead = n_e                      # first canonical pad slot (w == 0)
        steps = []
        for s in range(P):
            q = (p - s) % P
            m = (s_src // R) == q
            ids = np.nonzero(m)[0]
            fwd = _build_aligned_layout(
                s_dst[m], s_src[m] - q * R, R, dead,
                force_chunks=fwd_need, chunk_edges=RING_CHUNK_EDGES)
            rev = _build_aligned_layout(
                s_src[m] - q * R, s_dst[m], R, dead,
                force_chunks=rev_need, chunk_edges=RING_CHUNK_EDGES)
            steps.append(RingBuckets(fwd=_remap_gather(fwd, ids, dead),
                                     rev=_remap_gather(rev, ids, dead)))
        per_shard.append(jax.tree.map(lambda *xs: jnp.stack(xs), *steps))
    if mesh is not None:
        from kgat_tpu.parallel.multihost import stack_pytrees
        return stack_pytrees(per_shard, mesh, axis=_stack_axis(mesh))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *per_shard)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SelectiveHalo:
    """Static data for the selective halo all-to-all exchange.

    The refinement of the dense all-gather for tables too large to
    replicate (SURVEY.md §2.3 SP/CP row, ROADMAP): instead of gathering
    every shard's full activation block, each device ships exactly the
    owned rows its peers' edges reference. Per shard:

      send_idx   (P, H) int32  local rows THIS device sends to peer p
                               (padded with 0 — receivers never index pad
                               slots, their edge weights are 0)
      local_ids  (T,)  int32   global node id of each local-table slot:
                               [own rows | halo rows from peer 0.. | pad];
                               layer-0 features gather through this from
                               the replicated embedding table (no comm)
      fwd / rev  AlignedLayouts over LOCAL-TABLE coordinates: fwd segments
                               are local dst rows (0..R), fwd/rev node ids
                               index the (T,) local table; gather maps
                               aligned positions -> shard-canonical edge
                               slots (attention-weight staging)

    H and T are shard-uniform (max over shards, rounded so T is a multiple
    of 128 and equals rev.n_blocks * 128 — the custom-VJP cotangent of the
    local table must match its primal shape).
    """

    send_idx: jax.Array
    local_ids: jax.Array
    fwd: "AlignedLayout"
    rev: "AlignedLayout"
    halo_rows: int = dataclasses.field(metadata=dict(static=True))   # H
    table_rows: int = dataclasses.field(metadata=dict(static=True))  # T


def build_selective_halo(src: np.ndarray, dst: np.ndarray,
                         info: PartitionInfo, mesh=None,
                         chunk_edges: int = ALIGN_CHUNK_EDGES,
                         ) -> SelectiveHalo:
    """Build per-shard selective-exchange metadata (see SelectiveHalo).

    Must be called with the same (src, dst) arrays as
    :func:`partition_graph`; layout gathers index each shard's canonical
    (local-dst stable sorted) edge slots, like build_ring_buckets.
    """
    from kgat_tpu.graph import _build_aligned_layout, _stable_sort_perm

    P, R = info.n_parts, info.rows_per_part
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)

    # Pass 1: shard-canonical edge arrays + per-(shard, peer) needed rows.
    shard_edges = []
    need = []               # need[p][q]: sorted global rows of peer q
    H = 1
    for p in range(P):
        sel = (dst >= p * R) & (dst < (p + 1) * R)
        s_src, s_dst = src[sel], dst[sel] - p * R
        order = _stable_sort_perm(s_dst, R)
        s_src, s_dst = s_src[order], s_dst[order]
        shard_edges.append((s_src, s_dst))
        per_peer = []
        for q in range(P):
            rows = np.unique(s_src[(s_src // R) == q]) if len(s_src) \
                else np.zeros(0, np.int64)
            if q == p:
                rows = rows[:0]      # own rows are local already
            per_peer.append(rows)
            H = max(H, len(rows))
        need.append(per_peer)
    H = _round_up(H, ALIGN_BLOCK_ROWS)          # keep T a multiple of 128
    T = R + P * H                                # local-table rows

    # Pass 2: chunk budgets (shard-uniform static shapes).
    def _local_table_ids(p):
        """Map each of shard p's edge srcs to its local-table slot."""
        s_src = shard_edges[p][0]
        out = np.zeros(len(s_src), np.int64)
        for q in range(P):
            m = (s_src // R) == q
            if q == p:
                out[m] = s_src[m] - p * R
            elif m.any():
                pos = np.searchsorted(need[p][q], s_src[m])
                out[m] = R + q * H + pos
        return out

    fwd_need = rev_need = 1
    locs = [_local_table_ids(p) for p in range(P)]
    for p in range(P):
        s_dst = shard_edges[p][1]
        fwd_need = max(fwd_need, _needed_chunks(s_dst, R, chunk_edges))
        rev_need = max(rev_need, _needed_chunks(locs[p], T, chunk_edges))

    # Pass 3: per-shard arrays + layouts.
    per_shard = []
    for p in range(P):
        s_src, s_dst = shard_edges[p]
        n_e = len(s_src)
        dead = n_e
        send_idx = np.zeros((P, H), np.int32)
        for q in range(P):
            # Rows THIS shard (p) must send to peer q = rows of p that q
            # needs.
            rows = need[q][p]
            send_idx[q, : len(rows)] = (rows - p * R).astype(np.int32)
        local_ids = np.full(T, info.n_nodes_global, np.int64)
        local_ids[:R] = np.arange(p * R, (p + 1) * R)
        for q in range(P):
            rows = need[p][q]
            local_ids[R + q * H: R + q * H + len(rows)] = rows
        fwd = _build_aligned_layout(
            s_dst, locs[p], R, dead, order=np.arange(n_e, dtype=np.int64),
            force_chunks=fwd_need, chunk_edges=chunk_edges)
        rev = _build_aligned_layout(locs[p], s_dst, T, dead,
                                    force_chunks=rev_need,
                                    chunk_edges=chunk_edges)
        per_shard.append(SelectiveHalo(
            send_idx=jnp.asarray(send_idx),
            local_ids=jnp.asarray(local_ids.astype(np.int32)),
            fwd=fwd, rev=rev, halo_rows=H, table_rows=T))
    if mesh is not None:
        from kgat_tpu.parallel.multihost import stack_pytrees
        return stack_pytrees(per_shard, mesh, axis=_stack_axis(mesh))
    return jax.tree.map(lambda *xs: jnp.stack(xs), *per_shard)


def _pad_pieces(pieces, n: int, sentinel: int):
    """Pad a shard's RowPieces to n pieces (length 0, row past every
    output row) so all shards share one SPMD shape."""
    from kgat_tpu.graph import _pieces, host_array
    extra = n - pieces.start.shape[0]
    fill = {"start": 0, "length": 0, "row": sentinel}
    return _pieces({f: np.concatenate([host_array(pieces, f),
                                       np.full(extra, v, np.int32)])
                    for f, v in fill.items()})


def partition_graph(src: np.ndarray, dst: np.ndarray, etype: np.ndarray,
                    n_nodes: int, n_relations: int, n_parts: int,
                    mesh=None, rel_block: int = 1024,
                    ) -> Tuple[Graph, PartitionInfo]:
    """Partition edges by destination block into a stacked SPMD Graph.

    Returns a Graph whose array leaves have a leading (n_parts,) axis and
    whose static metadata is shard-uniform. Shard-local conventions:
    ``dst`` holds GLOBAL head ids (so attention gathers need no offset);
    the forward SpMM pieces sum into LOCAL rows (0..rows_per_part); the
    reverse pieces sum into GLOBAL source rows and ``rev_nbr`` holds local
    dst rows (feature gradients are per-shard partials over the whole
    table, summed by the all-gather transpose).

    mesh: when given, leaves are assembled shard-per-device over the
    mesh's leading axis (multihost.stack_pytrees) — required on multi-host
    (each process places only its local shards) and avoids per-step
    resharding on one host.

    rel_block: attention relation-block granularity (graph.build_graph).
    """
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    etype = np.asarray(etype, np.int64)
    R = _round_up(-(-n_nodes // n_parts), ALIGN_BLOCK_ROWS)
    info = PartitionInfo(n_parts=n_parts, rows_per_part=R,
                         n_nodes_global=n_nodes, n_nodes_pad=R * n_parts)

    shards = []
    for p in range(n_parts):
        sel = (dst >= p * R) & (dst < (p + 1) * R)
        shards.append((src[sel], dst[sel], etype[sel]))

    # Force shard-uniform shapes/static metadata.
    max_edges = max(len(s[0]) for s in shards)
    blk = 2048
    edge_pad = max(_round_up(max_edges + blk, blk), blk)
    rel_pad = {}
    for r in range(n_relations):
        m = max(int(np.sum(s[2] == r)) for s in shards)
        if m > 0:
            rel_pad[r] = _round_up(m, rel_block)

    built = [_build_shard(s_src, s_dst, s_ety, p, info, n_relations,
                          edge_pad, rel_pad, rel_block)
             for p, (s_src, s_dst, s_ety) in enumerate(shards)]
    sentinel = max(info.n_nodes_pad, n_nodes)
    for d in ("fwd_pieces", "rev_pieces"):
        n = max(getattr(g, d).start.shape[0] for g in built)
        built = [dataclasses.replace(g, **{d: _pad_pieces(getattr(g, d), n,
                                                          sentinel)})
                 if getattr(g, d).start.shape[0] != n else g
                 for g in built]

    if mesh is not None:
        from kgat_tpu.parallel.multihost import stack_pytrees
        stacked = stack_pytrees(built, mesh, axis=_stack_axis(mesh))
    else:
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *built)
    return stacked, info


def _build_shard(src, dst, ety, p, info: PartitionInfo, n_relations,
                 edge_pad, rel_pad, rel_block=1024) -> Graph:
    """One shard's Graph, in mixed coordinates (see partition_graph)."""
    from kgat_tpu.graph import host_array
    R = info.rows_per_part
    # Build against LOCAL dst so canonical order / CSR / forward pieces are
    # local, with src ids in the global space: build_graph gets the global
    # bound so its range checks pass (local dst < R <= bound), and its
    # reverse pieces sum into global src rows.
    g = build_graph(
        src.astype(np.int64), (dst - p * R).astype(np.int64),
        ety.astype(np.int64),
        n_nodes=max(info.n_nodes_pad, info.n_nodes_global),
        n_relations=n_relations,
        rel_block=rel_block,
        force_edge_pad=edge_pad, force_rel_pad=rel_pad,
    )
    # Global dst for attention gathers (sentinel -> global n_nodes).
    mask_h = host_array(g, "edge_mask")
    dst_h = host_array(g, "dst")
    dst_global = np.where(mask_h > 0, dst_h + p * R,
                          info.n_nodes_global).astype(np.int32)
    # Local CSR offsets over local dst (R + 2 rows incl. sentinel).
    dst_local_pad = np.where(mask_h > 0, dst_h, R)
    row_offsets = np.searchsorted(dst_local_pad,
                                  np.arange(R + 2)).astype(np.int32)

    out = dataclasses.replace(
        g,
        dst=jnp.asarray(dst_global),
        row_offsets=jnp.asarray(row_offsets),
        n_nodes=info.n_nodes_global,
        n_edges=-1,  # shard-dependent; uniform sentinel for SPMD stacking
    )
    object.__setattr__(out, "_host", {
        **g._host, "dst": dst_global, "row_offsets": row_offsets})
    return out
