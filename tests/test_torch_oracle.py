"""Cross-framework parity: KGAT vs an independent PyTorch oracle.

The reference stack is torch+DGL (SURVEY.md §2.1 model row; the reference
mount is empty, so the strongest available parity evidence is an
independent torch implementation of the SURVEY.md §2.8 equations). Unlike
the numpy oracle (tests/test_model.py), torch brings its own autograd —
so beyond forward activations this checks that OUR gradient structure
(jax.grad through spmm/segment-softmax/losses, incl. the custom_vjp
dual-op rules) matches a completely independent AD system:

  - attention logits + edge softmax        (A4 + A5)
  - L-layer propagation, all aggregators   (A1-A3 + concat)
  - cf_loss / kg_loss values               (eqs. 11-13 / 1-2)
  - d(cf_loss)/d{entity_embed, layer W}    vs torch.autograd
  - d(kg_loss)/d{entity_embed, w_rel, rel_embed} vs torch.autograd

All torch math runs in float64; jax runs its normal float32 path, so
tolerances are the f32 round-off of the tiny test graph.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kgat_tpu.models import kgat
from kgat_tpu.models.kgat import KGATConfig


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _ti(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.long)


def _torch_params(params, requires_grad=False):
    tp = {
        "entity_embed": _t(params["entity_embed"]),
        "rel_embed": _t(params["rel_embed"]),
        "w_rel": _t(params["w_rel"]),
        "layers": [{k: _t(v) for k, v in layer.items()}
                   for layer in params["layers"]],
    }
    if requires_grad:
        tp["entity_embed"].requires_grad_(True)
        tp["rel_embed"].requires_grad_(True)
        tp["w_rel"].requires_grad_(True)
        for layer in tp["layers"]:
            for v in layer.values():
                v.requires_grad_(True)
    return tp


def _torch_attention(tp, g):
    """A4 logits + A5 per-dst segment softmax over the real edges."""
    src, dst, ety = _ti(g.src), _ti(g.dst), _ti(g.etype)
    ne = g.n_edges
    src, dst, ety = src[:ne], dst[:ne], ety[:ne]
    W = tp["w_rel"][ety]                                     # (E, d, k)
    ph = torch.einsum("ed,edk->ek", tp["entity_embed"][dst], W) \
        + tp["rel_embed"][ety]
    pt = torch.einsum("ed,edk->ek", tp["entity_embed"][src], W)
    logits = (pt * torch.tanh(ph)).sum(-1)                   # (E,)
    # Segment softmax (per-dst), the composed-max/exp/sum way DGL's
    # edge_softmax is defined (SURVEY.md §2.2 edge_softmax row).
    neg_inf = torch.finfo(logits.dtype).min
    seg_max = torch.full((g.n_nodes,), neg_inf, dtype=logits.dtype)
    if hasattr(seg_max, "index_reduce"):
        seg_max = seg_max.index_reduce(0, dst, logits, "amax",
                                       include_self=True)
    else:  # pre-1.12 torch: scatter-based segment max
        seg_max = seg_max.scatter_reduce(0, dst, logits, "amax",
                                         include_self=True)
    z = torch.exp(logits - seg_max[dst])
    seg_sum = torch.zeros(g.n_nodes, dtype=logits.dtype)
    seg_sum = seg_sum.index_add(0, dst, z)
    att = z / seg_sum[dst]
    att_pad = torch.zeros(g.n_edges_pad, dtype=logits.dtype)
    att_pad[:ne] = att
    return logits, att_pad


def _torch_propagate(tp, g, att, cfg):
    """A1-A3 propagation + concat of l2-normalized layer outputs."""
    src = _ti(g.src)[: g.n_edges]
    dst = _ti(g.dst)[: g.n_edges]
    slope = cfg.leaky_relu_slope
    leaky = lambda x: torch.where(x >= 0, x, slope * x)
    l2 = lambda x: x / torch.sqrt(
        torch.clamp((x * x).sum(-1, keepdim=True), min=1e-12))
    ego = tp["entity_embed"]
    outs = [ego]
    for layer in tp["layers"]:
        side = torch.zeros_like(ego)
        side = side.index_add(0, dst, att[: g.n_edges, None] * ego[src])
        if cfg.aggregator == "gcn":
            ego = leaky((ego + side) @ layer["w"] + layer["b"])
        elif cfg.aggregator == "graphsage":
            ego = leaky(torch.cat([ego, side], -1) @ layer["w"]
                        + layer["b"])
        else:
            ego = (leaky((ego + side) @ layer["w1"] + layer["b1"])
                   + leaky((ego * side) @ layer["w2"] + layer["b2"]))
        outs.append(l2(ego))
    return torch.cat(outs, -1)


def _torch_cf_loss(tp, g, att, meta, users, pos, neg, cfg):
    all_embed = _torch_propagate(tp, g, att, cfg)
    u = all_embed[_ti(users) + meta.n_entities]
    ip = all_embed[_ti(pos)]
    ineg = all_embed[_ti(neg)]
    bpr = -torch.nn.functional.logsigmoid(
        (u * ip).sum(-1) - (u * ineg).sum(-1))
    reg = sum(0.5 * (t ** 2).sum() for t in (u, ip, ineg)) / u.shape[0]
    return bpr.mean() + cfg.reg_cf * reg


def _torch_kg_loss(tp, h, r, t_pos, t_neg, cfg):
    h, r, t_pos, t_neg = _ti(h), _ti(r), _ti(t_pos), _ti(t_neg)
    W = tp["w_rel"][r]
    e_r = tp["rel_embed"][r]
    proj = lambda e: torch.einsum("bd,bdk->bk", e, W)
    emb = tp["entity_embed"]
    ph, pp, pn = proj(emb[h]), proj(emb[t_pos]), proj(emb[t_neg])
    g_pos = ((ph + e_r - pp) ** 2).sum(-1)
    g_neg = ((ph + e_r - pn) ** 2).sum(-1)
    pair = -torch.nn.functional.logsigmoid(g_neg - g_pos)
    ssq = sum(0.5 * (t ** 2).sum() for t in (ph, e_r, pp, pn))
    return pair.mean() + cfg.reg_kg * ssq / h.shape[0]


@pytest.mark.parametrize("agg", ["gcn", "graphsage", "bi-interaction"])
def test_forward_parity_vs_torch(tiny_graph, agg):
    g, meta = tiny_graph
    cfg = KGATConfig(embed_dim=16, relation_dim=12, conv_dims=(16, 8),
                     mess_dropout=(0.0, 0.0), aggregator=agg)
    params = kgat.init_params(jax.random.key(5), meta.n_nodes,
                              meta.n_relations, cfg)
    tp = _torch_params(params)

    logits = np.asarray(kgat.attention_logits(params, g, cfg))
    att = np.asarray(kgat.compute_attention(params, g, cfg))
    want_logits, want_att = _torch_attention(tp, g)
    np.testing.assert_allclose(logits[: g.n_edges],
                               want_logits.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(att, want_att.numpy(), rtol=1e-4, atol=1e-6)

    out = np.asarray(kgat.propagate(params, g, jnp.asarray(att), cfg))
    want = _torch_propagate(tp, g, _t(att), cfg).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_cf_grad_parity_vs_torch_autograd(tiny_graph, backend):
    """jax.grad(cf_loss) — including the spmm custom_vjp dual-op rule on
    the model path (ref AND pallas kernels) — must match torch.autograd
    on the same batch. The pallas kernel runs in the Pallas interpreter."""
    g, meta = tiny_graph
    cfg = KGATConfig(embed_dim=16, relation_dim=12, conv_dims=(16, 8),
                     mess_dropout=(0.0, 0.0), ops_backend=backend,
                     interpret=True)
    params = kgat.init_params(jax.random.key(6), meta.n_nodes,
                              meta.n_relations, cfg)
    users = np.array([0, 3, 7], np.int32)
    pos = np.array([1, 4, 9], np.int32)
    neg = np.array([2, 11, 5], np.int32)

    att = kgat.compute_attention(params, g, cfg)
    prepared = kgat.prepare_attention(g, jax.lax.stop_gradient(att), cfg)
    loss, grads = jax.value_and_grad(kgat.cf_loss)(
        params, g, prepared, meta,
        jnp.asarray(users), jnp.asarray(pos), jnp.asarray(neg), cfg,
        train=False)

    tp = _torch_params(params, requires_grad=True)
    t_loss = _torch_cf_loss(tp, g, _t(att).detach(), meta,
                            users, pos, neg, cfg)
    t_loss.backward()

    np.testing.assert_allclose(float(loss), float(t_loss.detach()),
                               rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(grads["entity_embed"]), tp["entity_embed"].grad.numpy(),
        rtol=1e-3, atol=1e-5)
    for jl, tl in zip(grads["layers"], tp["layers"]):
        for k in jl:
            np.testing.assert_allclose(np.asarray(jl[k]),
                                       tl[k].grad.numpy(),
                                       rtol=1e-3, atol=1e-5)
    # CF phase must not touch TransR parameters (attention is cached).
    assert float(jnp.sum(jnp.abs(grads["w_rel"]))) == 0.0
    assert tp["w_rel"].grad is None


def test_kg_grad_parity_vs_torch_autograd(tiny_graph):
    g, meta = tiny_graph
    cfg = KGATConfig(embed_dim=16, relation_dim=12, conv_dims=(16,),
                     mess_dropout=(0.0,))
    params = kgat.init_params(jax.random.key(7), meta.n_nodes,
                              meta.n_relations, cfg)
    h = np.array([0, 5, 9], np.int32)
    r = np.array([0, 2, 1], np.int32)
    tpos = np.array([3, 6, 12], np.int32)
    tneg = np.array([8, 2, 14], np.int32)

    loss, grads = jax.value_and_grad(kgat.kg_loss)(
        params, jnp.asarray(h), jnp.asarray(r), jnp.asarray(tpos),
        jnp.asarray(tneg), cfg)

    tp = _torch_params(params, requires_grad=True)
    t_loss = _torch_kg_loss(tp, h, r, tpos, tneg, cfg)
    t_loss.backward()

    np.testing.assert_allclose(float(loss), float(t_loss.detach()),
                               rtol=1e-5)
    for key in ("entity_embed", "rel_embed", "w_rel"):
        np.testing.assert_allclose(np.asarray(grads[key]),
                                   tp[key].grad.numpy(),
                                   rtol=1e-3, atol=1e-5)
