"""KGAT: Knowledge Graph Attention Network, as pure JAX functions.

Implements the parity spec in SURVEY.md §2.8 (KGAT paper, Wang et al. KDD'19,
arXiv:1905.07854; reference repo `jennyzhang0215/DGL-KGAT` model.py —
reconstructed location, the reference mount was empty at survey time):

  (A4) attention logit   pi(h,r,t) = (W_r e_t)^T tanh(W_r e_h + e_r)
  (A5) edge softmax      per-dst segment softmax (edges oriented t -> h)
  (A1-A3) propagation    GCN / GraphSage / bi-interaction aggregators
  final representation   e* = e^(0) || e^(1) || ... || e^(L)
  BPR CF loss (eq.13), TransR KG loss (eqs.1-2)

Layer-output handling follows the original KGAT implementation the reference
reproduces: message dropout is applied to the layer output that feeds the
next layer; the L2-*normalized* copy goes into the concat list; the initial
embedding enters the concat unnormalized.

Everything is a pure function over a params dict; no framework state. The
message-passing backend (XLA reference path or the GPU SpMM kernel) is
resolved from the platform at trace time, so one model body serves both.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

from kgat_tpu.graph import CKGMeta, Graph
from kgat_tpu.ops import get_backend, resolve_backend

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class KGATConfig:
    """Reference hyperparameter recipe (SURVEY.md §2.9)."""

    embed_dim: int = 64           # entity/user embedding dim d
    relation_dim: int = 64        # relation space dim k
    conv_dims: Tuple[int, ...] = (64, 32, 16)
    mess_dropout: Tuple[float, ...] = (0.1, 0.1, 0.1)
    aggregator: str = "bi-interaction"  # gcn | graphsage | bi-interaction
    leaky_relu_slope: float = 0.2       # TF original's default alpha
    reg_cf: float = 1e-5
    reg_kg: float = 1e-5
    # ref | pallas; None = the platform's own (ops.resolve_backend).
    ops_backend: Any = None
    # Run the pallas kernels in the Pallas interpreter (CPU tests).
    interpret: bool = False
    dtype: Any = jnp.float32
    # SpMM value-stream dtype on the pallas backend (None = keep f32).
    # bf16 halves the bytes the kernel gathers; it accumulates in f32.
    compute_dtype: Any = None

    @property
    def out_dim(self) -> int:
        return self.embed_dim + sum(self.conv_dims)


def _xavier(rng, shape, dtype):
    fan_in, fan_out = shape[-2], shape[-1]
    limit = (6.0 / (fan_in + fan_out)) ** 0.5
    return jax.random.uniform(rng, shape, dtype, -limit, limit)


def init_params(rng: jax.Array, n_nodes: int, n_relations: int,
                cfg: KGATConfig, *, pretrain=None) -> Params:
    """Xavier-uniform init over full table shapes (matches the original impl).

    pretrain: optional (user_embed, item_embed, n_entities) — BPR-MF
    pretrained embeddings as in the reference's --use_pretrain npz
    (SURVEY.md §2.1 pretrain-loader row): item rows are entity ids
    [0, n_items), user rows sit at n_entities + uid.
    """
    keys = jax.random.split(rng, 4 + 4 * len(cfg.conv_dims))
    d, k = cfg.embed_dim, cfg.relation_dim
    entity = _xavier(keys[0], (n_nodes, d), cfg.dtype)
    if pretrain is not None:
        user_embed, item_embed, n_entities = pretrain
        user_embed = jnp.asarray(user_embed, cfg.dtype)
        item_embed = jnp.asarray(item_embed, cfg.dtype)
        if user_embed.shape[1] != d or item_embed.shape[1] != d:
            raise ValueError("pretrain dims do not match embed_dim")
        entity = entity.at[: item_embed.shape[0]].set(item_embed)
        entity = entity.at[n_entities: n_entities
                           + user_embed.shape[0]].set(user_embed)
    params: Params = {
        "entity_embed": entity,
        "rel_embed": _xavier(keys[1], (n_relations, k), cfg.dtype),
        "w_rel": _xavier(keys[2], (n_relations, d, k), cfg.dtype),
        "layers": [],
    }
    d_in = d
    ki = 4
    for d_out in cfg.conv_dims:
        if cfg.aggregator == "gcn":
            layer = {"w": _xavier(keys[ki], (d_in, d_out), cfg.dtype),
                     "b": jnp.zeros((d_out,), cfg.dtype)}
        elif cfg.aggregator == "graphsage":
            layer = {"w": _xavier(keys[ki], (2 * d_in, d_out), cfg.dtype),
                     "b": jnp.zeros((d_out,), cfg.dtype)}
        elif cfg.aggregator == "bi-interaction":
            layer = {"w1": _xavier(keys[ki], (d_in, d_out), cfg.dtype),
                     "b1": jnp.zeros((d_out,), cfg.dtype),
                     "w2": _xavier(keys[ki + 1], (d_in, d_out), cfg.dtype),
                     "b2": jnp.zeros((d_out,), cfg.dtype)}
        else:
            raise ValueError(f"unknown aggregator {cfg.aggregator!r}")
        params["layers"].append(layer)
        d_in = d_out
        ki += 2
    return params


# ---------------------------------------------------------------------------
# Attention (A4 + A5): relation-blocked TransR SDDMM, then segment softmax.
# ---------------------------------------------------------------------------

def attention_logits(params: Params, graph: Graph,
                     cfg: KGATConfig) -> jax.Array:
    """Per-edge unnormalized TransR attention logits in canonical edge order.

    Relation-blocked: each relation's edges are a static, padded contiguous
    block of ``graph.att_gather`` (SURVEY.md §3.2 loops over relations the
    same way; here each block is two fixed-shape matmuls).
    """
    emb = params["entity_embed"]
    dst = jnp.minimum(graph.dst, graph.n_nodes - 1)  # clamp sentinel
    att_logits_parts = []
    for (r, start, _cnt, cnt_pad) in graph.rel_blocks:
        idx = jax.lax.slice_in_dim(graph.att_gather, start, start + cnt_pad)
        e_h = emb[dst[idx]]                      # (B, d) heads
        e_t = emb[graph.src[idx]]                # (B, d) tails
        w_r = params["w_rel"][r]                 # (d, k)
        # HIGHEST: the logits feed a softmax over up to thousands of
        # edges; a GPU's default f32 dot may run in TF32 (~1e-3 relative).
        proj_h = jnp.dot(e_h, w_r, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        proj_t = jnp.dot(e_t, w_r, preferred_element_type=jnp.float32,
                         precision=jax.lax.Precision.HIGHEST)
        logit = jnp.sum(proj_t * jnp.tanh(proj_h + params["rel_embed"][r]),
                        axis=-1)
        att_logits_parts.append(logit.astype(cfg.dtype))
    flat = jnp.concatenate(att_logits_parts) if att_logits_parts else \
        jnp.zeros((0,), cfg.dtype)
    # Scatter relation-blocked logits back to canonical slots; pad positions
    # all point at the dead slot (first pad edge) and are masked downstream.
    logits = jnp.zeros((graph.n_edges_pad,), cfg.dtype)
    return logits.at[graph.att_gather].set(flat, mode="drop")


def compute_attention(params: Params, graph: Graph, cfg: KGATConfig) -> jax.Array:
    """Normalized edge attention (A4+A5). Recomputed per epoch with no grad
    in training (SURVEY.md §3.1/§3.2) — callers wrap in stop_gradient."""
    ops = get_backend(cfg.ops_backend)
    logits = attention_logits(params, graph, cfg)
    return ops.segment_softmax(graph, logits)


def prepare_attention(graph: Graph, att: jax.Array, cfg: KGATConfig):
    """Pre-stage cached attention for the hot loop.

    On the pallas backend this stages the masked weights in both SpMM
    orders (canonical and reverse) once per epoch; on the ref backend it is
    the identity.
    """
    if resolve_backend(cfg.ops_backend) == "pallas":
        from kgat_tpu.ops import pallas_backend
        return pallas_backend.prepare_weights(graph, att)
    return att


def attention_for_training(params: Params, graph: Graph, cfg: KGATConfig):
    """Per-epoch attention recompute, no grad, pre-staged for the hot loop
    (see prepare_attention)."""
    return jax.lax.stop_gradient(prepare_attention(
        graph, compute_attention(params, graph, cfg), cfg))


# ---------------------------------------------------------------------------
# Propagation (A1-A3) and final representation.
# ---------------------------------------------------------------------------

def _leaky(x, slope):
    return jnp.where(x >= 0, x, slope * x)


def _l2norm(x, eps=1e-12):
    return x / jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=-1, keepdims=True), eps))


def _spmm(cfg: KGATConfig):
    """The SpMM of the config's resolved backend."""
    ops = get_backend(cfg.ops_backend)
    if resolve_backend(cfg.ops_backend) == "pallas":
        return functools.partial(ops.spmm, interpret=cfg.interpret)
    return ops.spmm


def propagate(params: Params, graph: Graph, edge_att: jax.Array,
              cfg: KGATConfig, *, rng: jax.Array | None = None,
              train: bool = False) -> jax.Array:
    """L-layer attentive propagation -> concat representation (n_nodes, 176).

    SpMM per layer: e_N(h) = sum_{(h,r,t)} att(h,r,t) * e_t  (edges t -> h).
    """
    spmm = _spmm(cfg)
    low = (cfg.compute_dtype
           if resolve_backend(cfg.ops_backend) == "pallas" else None)
    ego = params["entity_embed"]
    outs = [ego]
    for li, layer in enumerate(params["layers"]):
        x_in = ego if low is None else ego.astype(low)
        side = spmm(graph, edge_att, x_in)
        if cfg.aggregator == "gcn":
            ego = _leaky((ego + side) @ layer["w"] + layer["b"],
                         cfg.leaky_relu_slope)
        elif cfg.aggregator == "graphsage":
            ego = _leaky(jnp.concatenate([ego, side], axis=-1) @ layer["w"]
                         + layer["b"], cfg.leaky_relu_slope)
        else:  # bi-interaction
            both = _leaky((ego + side) @ layer["w1"] + layer["b1"],
                          cfg.leaky_relu_slope)
            prod = _leaky((ego * side) @ layer["w2"] + layer["b2"],
                          cfg.leaky_relu_slope)
            ego = both + prod
        if train and cfg.mess_dropout[li] > 0:
            assert rng is not None, "propagate(train=True) needs an rng"
            rng, sub = jax.random.split(rng)
            keep = 1.0 - cfg.mess_dropout[li]
            mask = jax.random.bernoulli(sub, keep, ego.shape)
            ego = jnp.where(mask, ego / keep, 0.0)
        outs.append(_l2norm(ego))
    return jnp.concatenate(outs, axis=-1)


# ---------------------------------------------------------------------------
# CF (BPR) phase.
# ---------------------------------------------------------------------------

def cf_scores(all_embed: jax.Array, meta: CKGMeta, users: jax.Array,
              items: jax.Array) -> jax.Array:
    """y(u, i) = <e*_u, e*_i> for aligned index arrays (paper eq.12)."""
    u_emb = all_embed[meta.user_node(users)]
    i_emb = all_embed[items]
    return jnp.sum(u_emb * i_emb, axis=-1)


def _l2_reg_mean(*tensors):
    """0.5 * sum-of-squares, averaged over the batch (torch-reference style)."""
    b = tensors[0].shape[0]
    return sum(0.5 * jnp.sum(t.astype(jnp.float32) ** 2) for t in tensors) / b


def cf_loss(params: Params, graph: Graph, edge_att: jax.Array, meta: CKGMeta,
            users: jax.Array, pos_items: jax.Array, neg_items: jax.Array,
            cfg: KGATConfig, *, rng: jax.Array | None = None,
            train: bool = True,
            weight: jax.Array | None = None) -> jax.Array:
    """BPR loss over a minibatch with full-graph propagation (SURVEY.md §3.3).

    ``weight`` optionally down-weights batch rows (used when device-side
    rejection sampling fails to find a clean negative within its budget).
    """
    all_embed = propagate(params, graph, edge_att, cfg, rng=rng, train=train)
    u = all_embed[meta.user_node(users)]
    ip = all_embed[pos_items]
    ineg = all_embed[neg_items]
    pos = jnp.sum(u * ip, axis=-1)
    neg = jnp.sum(u * ineg, axis=-1)
    bpr = -jax.nn.log_sigmoid(pos - neg)
    if weight is not None:
        bpr = bpr * weight
        denom = jnp.maximum(jnp.sum(weight), 1.0)
        loss = jnp.sum(bpr) / denom
    else:
        loss = jnp.mean(bpr)
    return loss + cfg.reg_cf * _l2_reg_mean(u, ip, ineg)


# ---------------------------------------------------------------------------
# KG (TransR) phase.
# ---------------------------------------------------------------------------

def kg_pair_terms_rows(eh: jax.Array, ep: jax.Array, en: jax.Array,
                       e_r: jax.Array, w_r: jax.Array
                       ) -> Tuple[jax.Array, jax.Array]:
    """Row-based TransR core: per-pair loss terms from already-gathered
    embedding rows — eh/ep/en (B, d) head/pos-tail/neg-tail rows, e_r
    (B, k), w_r (B, d, k). Factored out so the sparse-Adam KG step can
    differentiate w.r.t. the GATHERED rows (keeping the entity-table
    gradient row-sparse) while the dense paths keep full-table grads."""
    proj = lambda e: jnp.einsum("bd,bdk->bk", e, w_r)
    ph, pp, pn = proj(eh), proj(ep), proj(en)
    g_pos = jnp.sum((ph + e_r - pp) ** 2, axis=-1)
    g_neg = jnp.sum((ph + e_r - pn) ** 2, axis=-1)
    pair = -jax.nn.log_sigmoid(g_neg - g_pos)
    ssq = sum(0.5 * jnp.sum(t.astype(jnp.float32) ** 2)
              for t in (ph, e_r, pp, pn))
    return pair, ssq


def kg_pair_terms(params: Params, h: jax.Array, r: jax.Array,
                  t_pos: jax.Array, t_neg: jax.Array
                  ) -> Tuple[jax.Array, jax.Array]:
    """TransR per-pair loss terms: (pairwise BPR losses, 0.5*sum-of-squares
    regularizer sum). Shared by the single-device loss and the shard_map'd
    data-parallel loss (which psums these partials)."""
    emb = params["entity_embed"]
    w_r = params["w_rel"][r]                        # (B, d, k)
    e_r = params["rel_embed"][r]                    # (B, k)
    return kg_pair_terms_rows(emb[h], emb[t_pos], emb[t_neg], e_r, w_r)


def kg_loss(params: Params, h: jax.Array, r: jax.Array, t_pos: jax.Array,
            t_neg: jax.Array, cfg: KGATConfig,
            weight: jax.Array | None = None) -> jax.Array:
    """TransR pairwise loss (paper eqs.1-2): plausibility
    g(h,r,t) = ||W_r e_h + e_r - W_r e_t||^2, minimize
    -log sigmoid(g(h,r,t-) - g(h,r,t+)). Pure embedding compute, no graph ops
    (SURVEY.md §3.4)."""
    pair, ssq = kg_pair_terms(params, h, r, t_pos, t_neg)
    if weight is not None:
        loss = jnp.sum(pair * weight) / jnp.maximum(jnp.sum(weight), 1.0)
    else:
        loss = jnp.mean(pair)
    return loss + cfg.reg_kg * ssq / h.shape[0]
