"""Attention-based recommendation explanations (the KGAT case study).

The model family's headline interpretability claim (KGAT paper §4.4, Fig.5:
"attentive high-order connectivity") is that the learned edge attentions
surface *why* an item was recommended: high-attention paths through the
collaborative knowledge graph connecting the user to the item. The
reference repo stops at metrics; this tool makes the claim operational:

    python -m kgat_tpu.explain --ckpt runs/amazon-r2c5_best \
        --dataset amazon-book --user 17 --item 305 --hops 2

It loads a trained checkpoint, recomputes the normalized edge attentions
(A4+A5), and runs a bidirectional attention-beam search: from the user node
and from the item node, walk incoming-message edges (head -> tail = walking
triples outward) keeping the highest attention-product partial paths; where
the two frontiers meet, the joined path is an explanation, scored by the
product of its edge attentions. With the CKG's built-in inverse relations
(graph.py build_ckg) this covers exactly the paper's u -> i1 -> e -> i
style paths.

Host-side by design: explanation is offline analysis over a few thousand
candidate edges, not a device hot loop — only the forward/attention pass is
jitted.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from kgat_tpu.graph import CKGMeta, Graph, host_array


@dataclasses.dataclass(frozen=True)
class AttentionIndex:
    """Host-side per-node top-``fanout`` incoming attention edges.

    Built once from the (dst-sorted) canonical edge list; reused across
    explain calls. ``nbr[n]`` / ``rel[n]`` / ``att[n]`` are the strongest
    in-edges of node n (src node, relation id, normalized attention),
    attention-descending, truncated to ``fanout``.
    """

    nbr: List[np.ndarray]
    rel: List[np.ndarray]
    att: List[np.ndarray]

    @property
    def n_nodes(self) -> int:
        return len(self.nbr)


def build_attention_index(graph: Graph, att, *, fanout: int = 16
                          ) -> AttentionIndex:
    """Group edges by dst and keep each node's top-``fanout`` by attention."""
    E = graph.n_edges
    src = host_array(graph, "src")[:E]
    dst = host_array(graph, "dst")[:E]
    ety = host_array(graph, "etype")[:E]
    a = np.asarray(att, dtype=np.float64)[:E]
    offs = host_array(graph, "row_offsets")
    n_nodes = int(offs.shape[0]) - 2  # last segment is the pad sentinel
    assert (dst[:-1] <= dst[1:]).all(), "canonical edges must be dst-sorted"
    nbr, rel, w = [], [], []
    for n in range(n_nodes):
        lo, hi = int(offs[n]), int(offs[n + 1])
        seg = np.argsort(-a[lo:hi], kind="stable")[:fanout] + lo
        nbr.append(src[seg])
        rel.append(ety[seg])
        w.append(a[seg])
    return AttentionIndex(nbr=nbr, rel=rel, att=w)


def _expand(index: AttentionIndex, start: int, hops: int, beam: int
            ) -> Dict[int, Tuple[float, List[Tuple[int, int, float]]]]:
    """Attention-product beam search over in-edges from ``start``.

    Returns {node: (best_weight, path)} over every node reached within
    ``hops`` steps, where path = [(from, rel, att), ...] of the steps taken
    (from=previous node). The start node itself is included with weight 1.
    """
    best: Dict[int, Tuple[float, List[Tuple[int, int, float]]]] = {
        start: (1.0, [])}
    frontier = [(start, 1.0, [])]
    for _ in range(hops):
        scored = []
        for node, wgt, path in frontier:
            for s, r, a in zip(index.nbr[node], index.rel[node],
                               index.att[node]):
                s = int(s)
                if s == node or s == start or any(s == p[0] for p in path):
                    continue  # simple paths only (also skips self-loops)
                scored.append((s, wgt * float(a),
                               path + [(node, int(r), float(a))]))
        scored.sort(key=lambda x: -x[1])
        frontier = scored[:beam]
        for node, wgt, path in frontier:
            if node not in best or wgt > best[node][0]:
                best[node] = (wgt, path)
    return best


def explain(graph: Graph, meta: CKGMeta, att, user: int, item: int, *,
            hops: int = 2, beam: int = 64, fanout: int = 16,
            n_paths: int = 3,
            index: Optional[AttentionIndex] = None) -> List[dict]:
    """Top attention paths connecting ``user`` and ``item``.

    Bidirectional: expand ``hops`` steps from each endpoint, join at
    meeting nodes, rank by the product of all edge attentions on the joined
    path. Returns at most ``n_paths`` dicts:
    ``{"strength", "meeting_node", "user_side", "item_side"}`` where each
    side is a list of {"from", "rel", "to", "att"} hops walking outward
    from its endpoint (triple direction: ``from --rel--> to``).
    """
    if not (0 <= user < meta.n_users):
        raise ValueError(f"user id must be in [0, {meta.n_users})")
    if not (0 <= item < meta.n_items):
        raise ValueError(f"item id must be in [0, {meta.n_items})")
    if index is None:
        index = build_attention_index(graph, att, fanout=fanout)
    u_node = int(meta.user_node(user))
    from_u = _expand(index, u_node, hops, beam)
    from_i = _expand(index, int(item), hops, beam)

    def render(path):
        return [{"from": f, "rel": r, "to": t, "att": round(a, 6)}
                for (f, r, a), t in zip(
                    path, [p[0] for p in path[1:]] + [None])]

    candidates = []
    for node in set(from_u) & set(from_i):
        wu, pu = from_u[node]
        wi, pi = from_i[node]
        if not pu and not pi:
            continue  # user == item is impossible; skip empty joins
        # keep the joined path simple: one side must not run through the
        # other side's endpoint (u -> i -> e <- i is not an explanation)
        if any(p[0] == item for p in pu) or any(p[0] == u_node for p in pi):
            continue
        candidates.append((wu * wi, node, pu, pi))
    candidates.sort(key=lambda x: -x[0])
    out = []
    for wgt, node, pu, pi in candidates[:n_paths]:
        su, si = render(pu), render(pi)
        if su:
            su[-1]["to"] = node
        if si:
            si[-1]["to"] = node
        out.append({"strength": wgt, "meeting_node": node,
                    "user_side": su, "item_side": si})
    return out


def node_kind(meta: CKGMeta, node: int) -> str:
    if node >= meta.n_entities:
        return f"user:{node - meta.n_entities}"
    if node < meta.n_items:
        return f"item:{node}"
    return f"entity:{node}"


def rel_kind(meta: CKGMeta, rel: int) -> str:
    R = meta.n_relations_kg
    if rel == meta.rel_interact:
        return "interact"
    if rel == meta.rel_interacted_by:
        return "interacted-by"
    return f"kg:{rel}" if rel < R else f"kg:{rel - R}^-1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Attention-path explanations from a kgat_tpu checkpoint")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--dataset", default=None)
    p.add_argument("--data-root", default="datasets")
    p.add_argument("--graph-cache", default=None, metavar="DIR")
    p.add_argument("--user", type=int, required=True)
    p.add_argument("--item", type=int, default=None,
                   help="item to explain; default: the user's top "
                        "recommendation")
    p.add_argument("--hops", type=int, default=2,
                   help="beam depth per side (2 covers u->i1->e<-i2<-i)")
    p.add_argument("--beam", type=int, default=64)
    p.add_argument("--fanout", type=int, default=16)
    p.add_argument("--n-paths", type=int, default=3)
    a = p.parse_args(argv)

    import jax
    from kgat_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    from kgat_tpu.data import load_dataset
    from kgat_tpu.models import kgat
    from kgat_tpu.recommend import _model_cfg_from_meta, recommend
    from kgat_tpu.utils.checkpoint import load_params

    params, meta_json = load_params(a.ckpt)
    dataset = a.dataset or meta_json.get("dataset")
    if not dataset or dataset == "synthetic":
        raise SystemExit("--dataset required (synthetic data is not "
                         "reconstructible from a name alone)")
    ds = load_dataset(a.data_root, dataset)
    graph, meta = ds.build(cache_dir=a.graph_cache)
    cfg = _model_cfg_from_meta(meta_json, {})

    item = a.item
    if item is None:
        items, _ = recommend(params, graph, meta, cfg, [a.user], k=1,
                             train_user_dict=ds.train_user_dict)
        item = int(items[0][0])
    att = np.asarray(jax.jit(
        lambda p_: kgat.compute_attention(p_, graph, cfg))(params))
    paths = explain(graph, meta, att, a.user, item, hops=a.hops,
                    beam=a.beam, fanout=a.fanout, n_paths=a.n_paths)
    for rec in paths:
        for side in ("user_side", "item_side"):
            for hop in rec[side]:
                hop["from_kind"] = node_kind(meta, hop["from"])
                hop["rel_kind"] = rel_kind(meta, hop["rel"])
                if hop["to"] is not None:
                    hop["to_kind"] = node_kind(meta, hop["to"])
    json.dump({"user": a.user, "item": item, "paths": paths}, sys.stdout)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
