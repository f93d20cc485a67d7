"""Graph core: a static-shape graph pytree + host-side builders.

Replacement for the reference stack's graph layer (SURVEY.md §2.2: DGL's
C++ graph index `src/graph/unit_graph.cc` — COO/CSR storage, format
conversion and caching). Instead of a mutable C++ object behind an FFI, the
graph here is an immutable pytree of padded, statically-shaped device arrays,
built once on the host and closed over by jitted functions.

Design decisions (all driven by XLA's static-shape compilation model):

* **Canonical edge order = destination-sorted.** Edge-softmax in the KGAT
  model normalizes attention over the triples headed by each node
  (SURVEY.md §2.8 A5); we orient every edge tail->head so dst == head, and
  dst-sorting makes the canonical order a CSR over destination rows: the
  segment ops are sorted-segment reductions and the SpMM kernel
  (ops/pallas_backend.py) reads each row's sources contiguously.
* **Padding with a sentinel segment.** Edges are padded to a block multiple;
  pad edges get ``dst == n_nodes`` (an extra, dead segment) and ``src == 0``
  so all gathers stay in bounds. Segment ops run with
  ``num_segments == n_nodes + 1`` and the last row is dropped.
* **Row pieces for the SpMM.** Both SpMM directions (forward over dst rows,
  backward over src rows) cut every CSR row into pieces of at most
  ``PIECE_EDGES`` positions (:class:`RowPieces`), so a hub row spreads
  over many kernel lanes instead of serializing one of them.
* **Relation-blocked attention layout.** The TransR attention SDDMM
  (SURVEY.md §2.8 A4) needs a per-relation 64x64 projection; computing it as
  one dense matmul per relation batches the work. ``att_gather`` is a
  static permutation from a relation-blocked (per-relation padded) layout to
  canonical edge slots; per-relation block extents are static metadata so the
  jitted model unrolls into R fixed-shape matmuls.

Reference parity notes: the CKG construction conventions mirror
``jennyzhang0215/DGL-KGAT``'s data loader (reconstructed; the reference
mount was empty — see SURVEY.md "Provenance warning"): entity ids occupy
``[0, n_entities)``, user node ids are ``n_entities + uid``, KG triples get
inverse counterparts with relation id ``r + n_relations_kg``, and user-item
interactions become two extra relations (interact / interacted-by).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Stage seconds of the most recent host graph build (build_graph /
# save+load), for the bench's build-breakdown line.
LAST_BUILD_STAGES: dict = {}

try:  # native (C++) fast path for host-side sorting; numpy fallback below
    from kgat_tpu import native as _native
except Exception:  # noqa: BLE001 - missing toolchain degrades gracefully
    _native = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _stable_sort_perm(keys: np.ndarray, n_keys: int) -> np.ndarray:
    """Stable sort permutation: native counting sort or numpy argsort."""
    if _native is not None and len(keys) > 0:
        return _native.sort_perm(keys, n_keys)
    return np.argsort(keys, kind="stable")


# Longest run of CSR positions one SpMM kernel lane reduces (RowPieces).
# Rows with more edges split into several pieces whose partial sums are
# added afterwards; short rows are one piece each.
PIECE_EDGES = 64


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RowPieces:
    """One SpMM direction's CSR rows cut into pieces of <= PIECE_EDGES
    consecutive positions, in row order. Empty rows have no piece; pieces
    added to pad a shard to a shared shape have length 0 and a row id past
    every output row (segment ops drop it)."""

    start: jax.Array   # (V,) int32 first CSR position of the piece
    length: jax.Array  # (V,) int32 positions in the piece (0..PIECE_EDGES)
    row: jax.Array     # (V,) int32 output row the piece sums into


def row_pieces(offsets: np.ndarray) -> dict:
    """Host-side RowPieces arrays from CSR offsets (n_rows + 1,)."""
    offsets = np.asarray(offsets, np.int64)
    deg = np.diff(offsets)
    n_p = -(-deg // PIECE_EDGES)
    row = np.repeat(np.arange(len(deg), dtype=np.int64), n_p)
    first = np.cumsum(n_p) - n_p
    j = np.arange(len(row), dtype=np.int64) - np.repeat(first, n_p)
    start = offsets[row] + j * PIECE_EDGES
    length = np.minimum(PIECE_EDGES, offsets[row + 1] - start)
    return {"start": start.astype(np.int32), "length": length.astype(np.int32),
            "row": row.astype(np.int32)}


def _pieces(arrs: dict) -> RowPieces:
    p = RowPieces(**{k: jnp.asarray(v) for k, v in arrs.items()})
    object.__setattr__(p, "_host", dict(arrs))
    return p


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Graph:
    """Padded, dst-sorted COO + CSR graph pytree.

    Array fields are pytree leaves (device arrays); int/tuple fields are
    static metadata baked into jitted programs.
    """

    # --- device arrays (pytree data) ---
    src: jax.Array          # (E_pad,) int32, tail of each edge (message source)
    dst: jax.Array          # (E_pad,) int32, head of each edge; == n_nodes for pads
    etype: jax.Array        # (E_pad,) int32 relation id; 0 for pads
    edge_mask: jax.Array    # (E_pad,) float32, 1.0 real / 0.0 pad
    row_offsets: jax.Array  # (n_nodes + 2,) int32 CSR offsets over dst segments
    att_gather: jax.Array   # (E_att_pad,) int32: relation-blocked pos -> canonical edge slot
    # SpMM forward: pieces of the dst rows over canonical positions (the
    # neighbours are ``src``). SpMM backward w.r.t. features runs the same
    # kernel on the REVERSE graph — DGL's dual-op autograd rule (SURVEY.md
    # §2.2): canonical edges stably sorted by src, with pads at the end.
    fwd_pieces: RowPieces
    rev_pieces: RowPieces
    rev_nbr: jax.Array      # (E_pad,) int32 dst per src-sorted position (0 for pads)
    rev_perm: jax.Array     # (E_pad,) int32 canonical slot per src-sorted position

    # --- static metadata (pytree aux) ---
    n_nodes: int = dataclasses.field(metadata=dict(static=True))
    n_edges: int = dataclasses.field(metadata=dict(static=True))      # real edges
    n_edges_pad: int = dataclasses.field(metadata=dict(static=True))  # padded length
    n_relations: int = dataclasses.field(metadata=dict(static=True))
    # ((rel_id, start, real_count, padded_count), ...) in att_gather layout
    rel_blocks: Tuple[Tuple[int, int, int, int], ...] = dataclasses.field(
        metadata=dict(static=True)
    )

    @property
    def num_segments(self) -> int:
        """Segment count for segment ops (includes the pad sentinel)."""
        return self.n_nodes + 1


def host_array(obj, field: str) -> np.ndarray:
    """Host-side numpy view of a device field of a Graph (or of one of its
    array-holding parts).

    The builders cache the numpy originals on the instance (``_host``), so
    host consumers — samplers, the partitioner, exporters — never copy
    device arrays back. Falls back to a device-to-host copy for instances
    reconstructed by pytree transforms.
    """
    cache = getattr(obj, "_host", None)
    if cache is None:
        cache = {}
        object.__setattr__(obj, "_host", cache)
    if field not in cache:
        cache[field] = np.asarray(getattr(obj, field))
    return cache[field]


def host_coo(g: "Graph") -> dict:
    """Host numpy {src, dst, etype} over the REAL (unpadded) edges."""
    return {k: host_array(g, k)[: g.n_edges] for k in ("src", "dst", "etype")}


# Bucket layouts of the partitioned ring and all-to-all exchanges
# (parallel/partition.py): 128-row output blocks whose edge runs are padded
# to chunk multiples.
ALIGN_BLOCK_ROWS = 128
ALIGN_CHUNK_EDGES = 1024


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AlignedLayout:
    """Block-aligned segment-reduce layout for one edge direction.

    Edges are ordered by segment (dst for forward, src for reverse), grouped
    into 128-row output blocks, each block's run padded to chunk multiples
    with dead positions (-> canonical pad slot, weight 0).
    """

    gather: jax.Array       # (E_al,) int32 aligned pos -> canonical edge slot
    node: jax.Array         # (E_al,) int32 the *other* endpoint per position
    seg: jax.Array          # (E_al,) int32 segment (owning row) per position
    bounds: jax.Array       # (n_blocks, 128, 8) int32 lane-minor [lo, hi)
    chunk_block: jax.Array  # (n_chunks,) int32 block id per chunk
    n_chunks: int = dataclasses.field(metadata=dict(static=True))
    n_blocks: int = dataclasses.field(metadata=dict(static=True))
    chunk_edges: int = dataclasses.field(default=ALIGN_CHUNK_EDGES,
                                         metadata=dict(static=True))


def _build_aligned_layout(seg: np.ndarray, other: np.ndarray,
                          n_nodes: int, dead_slot: int,
                          order: np.ndarray | None = None,
                          force_chunks: int | None = None,
                          chunk_edges: int = ALIGN_CHUNK_EDGES,
                          sort_within_seg: bool = True) -> AlignedLayout:
    """Host-side construction of an :class:`AlignedLayout`.

    seg/other: (n_edges,) segment id / other-endpoint per canonical edge;
    order: canonical edge ids sorted by seg (computed if None);
    force_chunks: pad the chunk count to this total (SPMD shards of a
    partitioned graph must share shapes — trailing chunks are dead);
    sort_within_seg: additionally sort each segment's run by the other
    endpoint, so the feature gather touches ascending rows within each run.
    """
    B, ALIGN = ALIGN_BLOCK_ROWS, chunk_edges
    n_edges = len(seg)
    if order is None:
        order = _stable_sort_perm(seg, n_nodes)
    if sort_within_seg and n_edges:
        # Stable two-key sort (seg, other): sort the seg-sorted order by
        # 'other' first, then re-sort by seg stably.
        by_other = order[np.argsort(other[order], kind="stable")]
        order = by_other[_stable_sort_perm(seg[by_other], n_nodes)]
    seg_sorted = seg[order]
    if _native is not None and n_nodes < 2**31 - 1:
        ro = _native.csr_offsets(seg_sorted, n_nodes)
    else:
        ro = np.searchsorted(seg_sorted,
                             np.arange(n_nodes + 1)).astype(np.int64)

    n_blocks = -(-n_nodes // B)
    blk_lo = ro[np.minimum(np.arange(n_blocks) * B, n_nodes)]
    blk_hi = ro[np.minimum(np.arange(n_blocks) * B + B, n_nodes)]
    blk_cnt = blk_hi - blk_lo
    # Empty blocks get zero chunks.
    blk_pad = (-(-blk_cnt // ALIGN)) * ALIGN
    blk_start = np.concatenate([[0], np.cumsum(blk_pad)])
    e_al = int(blk_start[-1])
    n_chunks_req = e_al // ALIGN
    if force_chunks is not None:
        if force_chunks < n_chunks_req:
            raise ValueError(f"force_chunks {force_chunks} < required "
                             f"{n_chunks_req}")
        e_al = int(force_chunks) * ALIGN

    if _native is not None:
        # Single-pass C++ fill (DGL's native format-conversion analog).
        gather32, node, seg_al, bounds, chunk_block = _native.aligned_fill(
            order, seg, other, ro, blk_start, n_nodes, B, ALIGN,
            dead_slot, e_al)
    else:
        gather = np.full(e_al, dead_slot, np.int64)
        for b in range(n_blocks):
            s, c = blk_start[b], blk_cnt[b]
            gather[s: s + c] = order[blk_lo[b]: blk_hi[b]]

        # Per-row aligned-coordinate bounds.
        rows = np.arange(n_nodes)
        row_block = rows // B
        lo = blk_start[row_block] + (ro[rows] - blk_lo[row_block])
        hi = lo + (ro[rows + 1] - ro[rows])
        lo_f = np.zeros(n_blocks * B, np.int64)
        hi_f = np.zeros(n_blocks * B, np.int64)
        lo_f[:n_nodes] = lo
        hi_f[:n_nodes] = hi
        bounds = np.zeros((n_blocks, B, 8), np.int32)
        bounds[:, :, 0] = lo_f.reshape(n_blocks, B)
        bounds[:, :, 1] = hi_f.reshape(n_blocks, B)

        chunk_block = np.repeat(np.arange(n_blocks, dtype=np.int32),
                                blk_pad // ALIGN)
        extra = e_al // ALIGN - len(chunk_block)
        if extra:
            # Dead trailing chunks: keep chunk_block monotone by pointing
            # them at the last block; their positions gather the dead slot.
            chunk_block = np.concatenate([
                chunk_block,
                np.full(extra, chunk_block[-1] if len(chunk_block)
                        else 0, np.int32)])
        if n_edges:
            clamped = np.minimum(gather, n_edges - 1)
            node = np.where(gather < n_edges, other[clamped],
                            0).astype(np.int32)
            seg_al = np.where(gather < n_edges, seg[clamped],
                              0).astype(np.int32)
        else:
            node = np.zeros(len(gather), np.int32)
            seg_al = np.zeros(len(gather), np.int32)
        gather32 = gather.astype(np.int32)
    layout = AlignedLayout(
        gather=jnp.asarray(gather32),
        node=jnp.asarray(node),
        seg=jnp.asarray(seg_al),
        bounds=jnp.asarray(bounds),
        chunk_block=jnp.asarray(chunk_block),
        n_chunks=int(len(chunk_block)),
        n_blocks=int(n_blocks),
        chunk_edges=int(ALIGN),
    )
    # Host mirrors (see host_array).
    object.__setattr__(layout, "_host",
                       {"gather": gather32, "node": node, "seg": seg_al,
                        "bounds": np.asarray(bounds),
                        "chunk_block": np.asarray(chunk_block)})
    return layout


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    etype: np.ndarray,
    n_nodes: int,
    n_relations: int,
    *,
    edge_block: int = 2048,
    rel_block: int = 1024,
    force_edge_pad: int | None = None,
    force_rel_pad: "dict[int, int] | None" = None,
) -> Graph:
    """Build a :class:`Graph` from host-side COO arrays.

    Replaces DGL's C++ COO->CSR conversion + format caching (SURVEY.md §2.2).
    Sorting/packing happens once on the host in numpy (a C++ fast path with
    identical output lives in kgat_tpu/native); the result is immutable.

    The ``force_*`` parameters pin padded shapes and static metadata so the
    per-device shards of a partitioned graph compile to one SPMD program
    (kgat_tpu.parallel.partition): force_rel_pad maps relation id -> padded
    block size and creates a block even for relations absent in this shard.
    """
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    etype = np.asarray(etype, dtype=np.int32)
    n_edges = int(src.shape[0])
    if not (dst < n_nodes).all() or not (dst >= 0).all():
        raise ValueError("dst out of range")
    if not (src < n_nodes).all() or not (src >= 0).all():
        raise ValueError("src out of range")
    if not (etype < n_relations).all():
        raise ValueError("etype out of range")

    LAST_BUILD_STAGES.clear()
    _t = _time.perf_counter()

    def _stage(name):
        nonlocal _t
        now = _time.perf_counter()
        LAST_BUILD_STAGES[name] = round(now - _t, 3)
        _t = now

    # Canonical order: stable sort by dst.
    order = _stable_sort_perm(dst, n_nodes)
    src, dst, etype = src[order], dst[order], etype[order]
    _stage("sort_s")

    # Pad edges to a block multiple with >= 1 pad slot: the attention
    # layout's padding and the reverse order's pads point at it.
    n_pad = max(_round_up(n_edges + edge_block, edge_block), edge_block)
    if force_edge_pad is not None:
        if force_edge_pad < n_edges + 1:
            raise ValueError("force_edge_pad leaves no pad slot")
        n_pad = int(force_edge_pad)
    pad = n_pad - n_edges
    src_p = np.concatenate([src, np.zeros(pad, np.int32)])
    dst_p = np.concatenate([dst, np.full(pad, n_nodes, np.int32)])
    ety_p = np.concatenate([etype, np.zeros(pad, np.int32)])
    mask = np.concatenate([np.ones(n_edges, np.float32), np.zeros(pad, np.float32)])

    # CSR offsets over dst segments (incl. sentinel segment n_nodes).
    row_offsets = np.searchsorted(dst_p, np.arange(n_nodes + 2), side="left")
    row_offsets = row_offsets.astype(np.int32)

    # SpMM pieces. Forward: the canonical order is already the dst CSR.
    # Reverse: canonical edges stably sorted by src (within a src row in
    # dst order), pads appended with weight slot `dead`.
    dead = n_edges  # first canonical pad slot (mask 0)
    fwd_pieces = row_pieces(row_offsets[: n_nodes + 1])
    rev_order = _stable_sort_perm(src, n_nodes)
    src_sorted = src[rev_order]
    if _native is not None and n_nodes < 2**31 - 1:
        rev_offsets = _native.csr_offsets(src_sorted, n_nodes)
    else:
        rev_offsets = np.searchsorted(src_sorted, np.arange(n_nodes + 1))
    rev_pieces = row_pieces(rev_offsets)
    rev_nbr = np.concatenate([dst[rev_order], np.zeros(pad, np.int32)])
    rev_perm = np.concatenate([rev_order.astype(np.int32),
                               np.full(pad, dead, np.int32)])
    _stage("spmm_pieces_s")

    # Relation-blocked attention layout: stable argsort by etype over the
    # canonical order, then pad each relation block to rel_block with the
    # dead slot (index n_edges, the first pad slot).
    rel_order = np.argsort(ety_p[:n_edges], kind="stable")
    rel_sorted_ety = ety_p[:n_edges][rel_order]
    gather_parts = []
    rel_blocks = []
    pos = 0
    for r in range(n_relations):
        lo = np.searchsorted(rel_sorted_ety, r, side="left")
        hi = np.searchsorted(rel_sorted_ety, r, side="right")
        cnt = int(hi - lo)
        if force_rel_pad is not None:
            cnt_pad = int(force_rel_pad.get(r, 0))
            if cnt_pad < cnt:
                raise ValueError(f"force_rel_pad[{r}]={cnt_pad} < {cnt}")
        else:
            cnt_pad = _round_up(max(cnt, 0), rel_block) if cnt > 0 else 0
        if cnt_pad == 0:
            continue
        part = np.full(cnt_pad, np.int32(dead), np.int32)
        part[:cnt] = rel_order[lo:hi].astype(np.int32)
        gather_parts.append(part)
        # Under forced padding the real count varies per SPMD shard; keep
        # the static tuple shard-uniform with a -1 sentinel.
        rel_blocks.append((r, pos, -1 if force_rel_pad is not None else cnt,
                           cnt_pad))
        pos += cnt_pad
    att_gather = (
        np.concatenate(gather_parts) if gather_parts else np.zeros(0, np.int32)
    )
    _stage("att_blocks_s")

    g = Graph(
        src=jnp.asarray(src_p),
        dst=jnp.asarray(dst_p),
        etype=jnp.asarray(ety_p),
        edge_mask=jnp.asarray(mask),
        row_offsets=jnp.asarray(row_offsets),
        att_gather=jnp.asarray(att_gather),
        fwd_pieces=_pieces(fwd_pieces),
        rev_pieces=_pieces(rev_pieces),
        rev_nbr=jnp.asarray(rev_nbr),
        rev_perm=jnp.asarray(rev_perm),
        n_nodes=int(n_nodes),
        n_edges=n_edges,
        n_edges_pad=int(n_pad),
        n_relations=int(n_relations),
        rel_blocks=tuple(rel_blocks),
    )
    object.__setattr__(g, "_host", {
        "src": src_p, "dst": dst_p, "etype": ety_p, "edge_mask": mask,
        "att_gather": att_gather, "row_offsets": row_offsets,
        "rev_nbr": rev_nbr, "rev_perm": rev_perm,
    })
    _stage("finalize_s")
    return g


GRAPH_CACHE_VERSION = 4  # bump when the Graph schema changes

_ARRAYS = ("src", "dst", "etype", "edge_mask", "row_offsets", "att_gather",
           "rev_nbr", "rev_perm")
_PIECE_FIELDS = ("start", "length", "row")


def save_graph(path: str, g: Graph, meta: "CKGMeta | None" = None) -> str:
    """Serialize a built Graph (+ optional CKGMeta) to one ``.npz`` file.

    The analog of DGL's graph-format caching (SURVEY.md §2.2 graph-index
    row: DGL caches COO/CSR conversions in its C++ index; here the whole
    built artifact — canonical arrays, both SpMM directions, static
    metadata — round-trips through disk so repeated runs on big datasets
    skip the host build entirely).
    """
    import json

    statics = {
        "version": GRAPH_CACHE_VERSION,
        "n_nodes": g.n_nodes, "n_edges": g.n_edges,
        "n_edges_pad": g.n_edges_pad, "n_relations": g.n_relations,
        "rel_blocks": [list(b) for b in g.rel_blocks],
    }
    if meta is not None:
        statics["meta"] = dataclasses.asdict(meta)
    arrays = {k: host_array(g, k) for k in _ARRAYS}
    for d in ("fwd", "rev"):
        pieces = getattr(g, f"{d}_pieces")
        arrays.update({f"{d}_{f}": host_array(pieces, f)
                       for f in _PIECE_FIELDS})
    arrays["statics_json"] = np.frombuffer(
        json.dumps(statics).encode(), dtype=np.uint8)
    import os
    # Unique tmp per writer: concurrent processes saving the same cache
    # entry must not interleave into one torn file before os.replace.
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_graph(path: str) -> "Tuple[Graph, CKGMeta | None]":
    """Load a Graph saved by :func:`save_graph`. Raises ValueError on a
    schema-version mismatch (callers fall back to rebuilding)."""
    import json

    z = np.load(path)
    statics = json.loads(bytes(np.asarray(z["statics_json"])).decode())
    if statics.get("version") != GRAPH_CACHE_VERSION:
        raise ValueError(f"graph cache version {statics.get('version')} != "
                         f"{GRAPH_CACHE_VERSION}")
    host = {k: np.asarray(z[k]) for k in _ARRAYS}
    pieces = {d: _pieces({f: np.asarray(z[f"{d}_{f}"])
                          for f in _PIECE_FIELDS}) for d in ("fwd", "rev")}
    g = Graph(
        **{k: jnp.asarray(v) for k, v in host.items()},
        fwd_pieces=pieces["fwd"],
        rev_pieces=pieces["rev"],
        n_nodes=int(statics["n_nodes"]),
        n_edges=int(statics["n_edges"]),
        n_edges_pad=int(statics["n_edges_pad"]),
        n_relations=int(statics["n_relations"]),
        rel_blocks=tuple(tuple(b) for b in statics["rel_blocks"]),
    )
    object.__setattr__(g, "_host", host)
    meta = CKGMeta(**statics["meta"]) if "meta" in statics else None
    return g, meta


@dataclasses.dataclass(frozen=True)
class CKGMeta:
    """Static description of a collaborative knowledge graph's id spaces."""

    n_users: int
    n_entities: int   # includes items: item ids are entity ids [0, n_items)
    n_items: int
    n_relations_kg: int   # original KG relations, before inverses/interact
    n_relations: int      # total relation ids in the CKG (2*kg + 2)
    rel_interact: int     # etype of the user<-item "interact" edges (dst=user)
    rel_interacted_by: int

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_entities

    def user_node(self, uid):
        """Map a user id to its CKG node id (users sit after entities)."""
        return self.n_entities + uid


def build_ckg(
    cf_pairs: np.ndarray,
    kg_triples: np.ndarray,
    n_users: int,
    n_entities: int,
    n_items: int,
    n_relations_kg: int,
    *,
    edge_block: int = 2048,
    rel_block: int = 1024,
) -> Tuple[Graph, CKGMeta]:
    """Construct the collaborative knowledge graph (SURVEY.md §2.4).

    ``cf_pairs``: (n_inter, 2) int array of (user, item).
    ``kg_triples``: (n_trip, 3) int array of (h, r, t).

    Edge orientation: every triple (h, r, t) becomes a message edge t -> h
    (src=t, dst=h), so that per-dst edge-softmax normalizes over the triples
    headed by h — the KGAT paper's softmax direction (SURVEY.md §2.8 A5, the
    #1 silent-divergence risk called out there).

    Relations: r in [0, R) original; r+R the inverse triple (t, r+R, h);
    2R = interact (edge item -> user, i.e. triple (u, interact, i));
    2R+1 = interacted-by (edge user -> item).
    """
    cf_pairs = np.asarray(cf_pairs, dtype=np.int64)
    kg_triples = np.asarray(kg_triples, dtype=np.int64)
    R = int(n_relations_kg)
    meta = CKGMeta(
        n_users=int(n_users),
        n_entities=int(n_entities),
        n_items=int(n_items),
        n_relations_kg=R,
        n_relations=2 * R + 2,
        rel_interact=2 * R,
        rel_interacted_by=2 * R + 1,
    )

    h, r, t = kg_triples[:, 0], kg_triples[:, 1], kg_triples[:, 2]
    u = meta.user_node(cf_pairs[:, 0])
    i = cf_pairs[:, 1]

    # (src=t, dst=h, r)           : original triple, message tail->head
    # (src=h, dst=t, r+R)         : inverse triple
    # (src=i, dst=u, 2R)          : interact        — softmax over items per user
    # (src=u, dst=i, 2R+1)        : interacted-by   — softmax over users per item
    src = np.concatenate([t, h, i, u])
    dst = np.concatenate([h, t, u, i])
    ety = np.concatenate([r, r + R, np.full(len(u), 2 * R), np.full(len(u), 2 * R + 1)])

    g = build_graph(
        src, dst, ety,
        n_nodes=meta.n_nodes,
        n_relations=meta.n_relations,
        edge_block=edge_block,
        rel_block=rel_block,
    )
    return g, meta
