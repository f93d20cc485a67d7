"""Partitioned execution: shard_map ops over the edge-partition ('ep') axis.

Communication structure (SURVEY.md §2.3, the ring-attention/CP analog for
graphs): with 1D dst-partitioning,

  attention (SDDMM + edge softmax)  -> zero communication
  propagation SpMM forward          -> all-gather of layer activations
                                       (boundary embeddings)
  SpMM backward feature grads       -> the all-gather's transpose
                                       (reduce-scatter/psum), inserted by
                                       shard_map's AD automatically
  loss/parameter gradients          -> psum (data-parallel over the same
                                       axis: CF batches are ep-sharded too)

The reference has no distributed path at all (SURVEY.md §2.3); there is
nothing to port. On GPUs, XLA runs these collectives over NCCL.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

from kgat_tpu.graph import ALIGN_BLOCK_ROWS, CKGMeta, Graph
from kgat_tpu.models import kgat
from kgat_tpu.ops import pallas_backend as pb
from kgat_tpu.ops import resolve_backend
from kgat_tpu.parallel.partition import PartitionInfo

AXIS = "ep"


def _local(tree):
    """Strip the leading shard axis inside shard_map (leaf shape (1, ...))."""
    return jax.tree.map(lambda a: a[0], tree)


# ---------------------------------------------------------------------------
# Bucket SpMM of the ring and all-to-all exchanges: an XLA segment_sum over
# an AlignedLayout, (T, d) features -> (n_out, d) rows, whose VJP reduces the
# cotangent over the bucket's reverse layout.
# ---------------------------------------------------------------------------

def _xla_reduce(layout, w_aligned, x, n_out):
    vals = x[layout.node] * w_aligned[:, None]
    # Dead positions carry w == 0 and seg == 0 (interspersed, so the ids
    # are not globally sorted).
    return jax.ops.segment_sum(vals, layout.seg, num_segments=n_out)


@jax.custom_vjp
def _bucket_spmm(w_fwd, w_rev, x, fwd_layout, rev_layout):
    return _xla_reduce(fwd_layout, w_fwd, x,
                       fwd_layout.n_blocks * ALIGN_BLOCK_ROWS)


def _bucket_spmm_fwd(w_fwd, w_rev, x, fwd_layout, rev_layout):
    return _bucket_spmm(w_fwd, w_rev, x, fwd_layout, rev_layout), \
        (w_fwd, w_rev, x, fwd_layout, rev_layout)


def _bucket_spmm_bwd(res, g):
    w_fwd, w_rev, x, fwd_layout, rev_layout = res
    d_w_fwd = jnp.sum(x[fwd_layout.node] * g[fwd_layout.seg],
                      axis=-1).astype(w_fwd.dtype)
    n_in = rev_layout.n_blocks * ALIGN_BLOCK_ROWS
    d_x = _xla_reduce(rev_layout, w_rev, g.astype(x.dtype), n_in)
    return (d_w_fwd, None, d_x.astype(x.dtype), None, None)


_bucket_spmm.defvjp(_bucket_spmm_fwd, _bucket_spmm_bwd)


# ---------------------------------------------------------------------------
# Partitioned model fns. All are *inner* fns meant to run inside shard_map.
# ---------------------------------------------------------------------------

import dataclasses


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RingWeights:
    """Attention weights staged into every ring bucket's aligned layouts:
    (P_ring, E_bucket_al) forward / reverse, indexed by ring step."""

    fwd: jax.Array
    rev: jax.Array


def make_partitioned(mesh: Mesh, pgraph: Graph, info: PartitionInfo,
                     meta: CKGMeta, cfg: kgat.KGATConfig,
                     exchange: str = "allgather", ring_buckets=None,
                     sel_halo=None, dp_axis: str | None = None):
    """Build jitted partitioned attention / propagate / cf-step callables.

    exchange:
      'allgather' — dense-graph fast path: one activation all-gather per
        layer (bandwidth-optimal when every shard touches most rows). Each
        shard runs the single-device SpMM of the resolved ops backend over
        its own CSR pieces.
      'ring' — the overlapped exchange: per-layer ring of (bucket reduce,
        ppermute) steps — each device reduces the edge bucket whose source
        chunk just arrived while the next chunk is in flight; requires
        ring_buckets (partition.build_ring_buckets).
      'a2a' — selective halo all-to-all: each device ships exactly the
        owned rows its peers' edges reference; activations live in a
        (table_rows, d) LOCAL table, never replicated — the path for
        tables too large to replicate; requires sel_halo
        (partition.build_selective_halo).
      The ring and a2a bucket reduces are XLA segment sums.

    dp_axis: name of a data-parallel mesh axis for a 2D (dp, ep) mesh:
      the graph and its exchanges shard over `ep` (replicated across dp
      rows), while CF minibatches shard over BOTH axes and loss/grad
      reductions psum over both. None (default) = 1D ep-only mesh.
    """
    N, n_pad, R = info.n_nodes_global, info.n_nodes_pad, info.rows_per_part
    nP = info.n_parts
    if exchange == "ring" and ring_buckets is None:
        raise ValueError("exchange='ring' requires ring_buckets "
                         "(partition.build_ring_buckets)")
    if exchange == "a2a" and sel_halo is None:
        raise ValueError("exchange='a2a' requires sel_halo "
                         "(partition.build_selective_halo)")
    if exchange not in ("allgather", "ring", "a2a"):
        raise ValueError(f"unknown exchange {exchange!r}")
    ring = exchange == "ring"
    a2a = exchange == "a2a"
    extra = ring_buckets if ring else (sel_halo if a2a else None)
    batch_axes = AXIS if dp_axis is None else (dp_axis, AXIS)
    kernel = resolve_backend(cfg.ops_backend) == "pallas"
    _perm = [(i, (i + 1) % nP) for i in range(nP)]

    def _ring_shift(v):
        return jax.lax.ppermute(v, AXIS, _perm)

    def attention_inner(g_stack, params, *ex_stack):
        g = _local(g_stack)
        # Attention is zero-comm under dst partitioning (SURVEY.md §3.2):
        # each shard runs the single-device attention on its own edges.
        att = jax.lax.stop_gradient(kgat.compute_attention(params, g, cfg))
        if ring or a2a:
            ex = _local(ex_stack[0])
            wm = att * g.edge_mask
            ew = RingWeights(fwd=wm[ex.fwd.gather], rev=wm[ex.rev.gather])
        else:
            ew = pb.prepare_weights(g, att)
        return jax.tree.map(lambda a: a[None], (att, ew))

    att_in_specs = (P(AXIS), P()) + ((P(AXIS),) if extra is not None else ())
    attention = jax.jit(jax.shard_map(
        attention_inner, mesh=mesh,
        in_specs=att_in_specs, out_specs=P(AXIS),
        check_vma=False))
    if extra is not None:
        _attention = attention
        attention = lambda g_stack, params: _attention(  # noqa: E731
            g_stack, params, extra)

    def _ring_side(rb, ew, chunk):
        """One layer's ring exchange: statically unrolled (reduce, permute)
        pairs — XLA overlaps the ppermute with the bucket reduce."""
        side = jnp.zeros((R, chunk.shape[1]), jnp.float32)
        for s in range(nP):
            fwdl = jax.tree.map(lambda a: a[s], rb.fwd)
            revl = jax.tree.map(lambda a: a[s], rb.rev)
            side = side + _bucket_spmm(ew.fwd[s], ew.rev[s], chunk, fwdl,
                                       revl)
            if s < nP - 1:
                chunk = _ring_shift(chunk)
        return side

    def _allgather_side(g, ew, x, p_idx):
        """The shard's SpMM over the replicated (n_pad, d) features."""
        rows = g.dst - p_idx * R     # local dst rows (pads carry w == 0)
        if kernel:
            low = cfg.compute_dtype
            return pb.spmm_pieces(
                ew, x if low is None else x.astype(low), g.fwd_pieces,
                g.src, rows, R, g.rev_pieces, g.rev_nbr, n_pad,
                interpret=cfg.interpret)
        return jax.ops.segment_sum(x[g.src] * ew.fwd[:, None], rows,
                                   num_segments=R)

    def _a2a_table(sh, ego):
        """Selective exchange: ship exactly the rows each peer needs, then
        assemble the (T, d) local feature table [own | halo | pad]."""
        send = ego[sh.send_idx]                        # (P, H, d)
        recv = jax.lax.all_to_all(send, AXIS, 0, 0)    # block q <- peer q
        halo = recv.reshape(nP * sh.halo_rows, ego.shape[-1])
        return jnp.concatenate([ego, halo])

    def propagate_inner(g_stack, ew_stack, params, rng, train: bool,
                        rb_stack=None):
        g = _local(g_stack)
        ew = _local(ew_stack)
        ex = _local(rb_stack) if extra is not None else None
        p_idx = jax.lax.axis_index(AXIS)
        ego_g = params["entity_embed"]
        x = jnp.pad(ego_g, ((0, n_pad - N), (0, 0)))
        if a2a:
            # Layer-0 features come straight off the replicated embedding
            # table (no comm); sentinel slots clamp to an arbitrary row —
            # every aligned position referencing them carries weight 0.
            local_x = x[jnp.minimum(ex.local_ids, n_pad - 1)]
            ego = local_x[:R]
        else:
            ego = jax.lax.dynamic_slice(x, (p_idx * R, 0), (R, x.shape[1]))
        outs_own = [ego] if (ring or a2a) else None
        outs = [ego_g]
        n_layers = len(params["layers"])
        for li, layer in enumerate(params["layers"]):
            if ring:
                side = _ring_side(ex, ew, ego)
            elif a2a:
                side = _bucket_spmm(ew.fwd, ew.rev, local_x, ex.fwd, ex.rev)
            else:
                side = _allgather_side(g, ew, x, p_idx)
                ego = jax.lax.dynamic_slice(x, (p_idx * R, 0),
                                            (R, x.shape[1]))
            slope = cfg.leaky_relu_slope
            leaky = lambda v: jnp.where(v >= 0, v, slope * v)  # noqa: E731
            if cfg.aggregator == "gcn":
                ego = leaky((ego + side) @ layer["w"] + layer["b"])
            elif cfg.aggregator == "graphsage":
                ego = leaky(jnp.concatenate([ego, side], -1) @ layer["w"]
                            + layer["b"])
            else:
                ego = (leaky((ego + side) @ layer["w1"] + layer["b1"])
                       + leaky((ego * side) @ layer["w2"] + layer["b2"]))
            if train and cfg.mess_dropout[li] > 0:
                rng, sub = jax.random.split(rng)
                # Independent dropout per DEVICE (not just per ep shard:
                # dp replicas hold the same rows but different batches).
                fold = p_idx if dp_axis is None else (
                    p_idx + nP * jax.lax.axis_index(dp_axis))
                sub = jax.random.fold_in(sub, fold)
                keep = 1.0 - cfg.mess_dropout[li]
                m = jax.random.bernoulli(sub, keep, ego.shape)
                ego = jnp.where(m, ego / keep, 0.0)
            if ring or a2a:
                # Rows stay owned; normalization is row-local. ONE final
                # all-gather of the concat representation replaces the
                # per-layer gathers of the dense path.
                outs_own.append(ego / jnp.sqrt(jnp.maximum(
                    jnp.sum(ego ** 2, -1, keepdims=True), 1e-12)))
                if a2a and li < n_layers - 1:
                    local_x = _a2a_table(ex, ego)
            else:
                # One all-gather per layer of the boundary embeddings.
                x = jax.lax.all_gather(ego, AXIS, tiled=True)   # (n_pad, d)
                norm = x[:N] / jnp.sqrt(jnp.maximum(
                    jnp.sum(x[:N] ** 2, -1, keepdims=True), 1e-12))
                outs.append(norm)
        if ring or a2a:
            own = jnp.concatenate(outs_own, axis=-1)            # (R, D)
            full = jax.lax.all_gather(own, AXIS, tiled=True)    # (n_pad, D)
            return full[:N]
        return jnp.concatenate(outs, axis=-1)                # (N, D) replicated

    def cf_loss_inner(g_stack, ew_stack, params, u, ip, ineg, w, rng,
                      rb_stack=None):
        all_embed = propagate_inner(g_stack, ew_stack, params, rng, True,
                                    rb_stack=rb_stack)
        ue = all_embed[meta.user_node(u)]
        pe = all_embed[ip]
        ne = all_embed[ineg]
        pos = jnp.sum(ue * pe, -1)
        neg = jnp.sum(ue * ne, -1)
        bpr = -jax.nn.log_sigmoid(pos - neg) * w
        n_valid = jnp.maximum(jax.lax.psum(jnp.sum(w), batch_axes), 1.0)
        loss = jax.lax.psum(jnp.sum(bpr), batch_axes) / n_valid
        reg = jax.lax.psum(
            0.5 * (jnp.sum(ue ** 2) + jnp.sum(pe ** 2) + jnp.sum(ne ** 2)),
            batch_axes) / n_valid
        return loss + cfg.reg_cf * reg

    # The stacked graph (and the exchange statics) are GLOBAL sharded
    # arrays: on a multi-host mesh they span non-addressable devices, so
    # every jitted program must receive them as ARGUMENTS — closing over
    # them is a lowering error on a real process group (caught by
    # tests/test_multihost_2proc.py). The public callables keep their
    # signatures via thin wrappers that supply (pgraph, extra) at call
    # time, outside any jit trace.
    def cf_loss_smapped(params, g_stack, ex, ew_stack, u, ip, ineg, w, rng):
        PB = P(batch_axes)
        specs = (P(AXIS), P(AXIS), P(), PB, PB, PB, PB, P())
        if extra is not None:
            smapped = jax.shard_map(
                lambda g, e, p, uu, pp, nn, ww, rr, rb: cf_loss_inner(
                    g, e, p, uu, pp, nn, ww, rr, rb_stack=rb),
                mesh=mesh, in_specs=specs + (P(AXIS),), out_specs=P(),
                check_vma=False)
            return smapped(g_stack, ew_stack, params, u, ip, ineg, w, rng,
                           ex)
        smapped = jax.shard_map(
            lambda g, e, p, uu, pp, nn, ww, rr: cf_loss_inner(
                g, e, p, uu, pp, nn, ww, rr),
            mesh=mesh, in_specs=specs, out_specs=P(), check_vma=False)
        return smapped(g_stack, ew_stack, params, u, ip, ineg, w, rng)

    def make_cf_step(opt: optax.GradientTransformation):
        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def _step(params, opt_state, g_stack, ex, ew_stack, u, ip, ineg,
                  w, rng):
            loss, grads = jax.value_and_grad(cf_loss_smapped)(
                params, g_stack, ex, ew_stack, u, ip, ineg, w, rng)
            updates, opt_state = opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        def step(params, opt_state, ew_stack, u, ip, ineg, w, rng):
            return _step(params, opt_state, pgraph, extra, ew_stack,
                         u, ip, ineg, w, rng)

        return step

    def make_cf_scan(opt: optax.GradientTransformation, cf_table,
                     batch_size: int):
        """Device-resident partitioned CF phase: lax.scan over minibatches.

        Device-side sampling, the shard_map'd partitioned loss, and the
        optimizer all run inside ONE compiled program per chunk of steps —
        the multi-chip analog of the single-device chunked epoch (the
        per-batch host loop costs ~3,700 dispatch round trips per epoch at
        reference scale; this costs ~20).
        """
        from kgat_tpu.sampler import sample_cf_batch

        @functools.partial(jax.jit, donate_argnums=(0, 1))
        def _scan(params, opt_state, g_stack, ex, ew_stack, keys):
            def step(carry, key):
                params, opt_state = carry
                k_s, k_d = jax.random.split(key)
                u, ip, ineg, w = sample_cf_batch(cf_table, k_s, batch_size)
                loss, grads = jax.value_and_grad(cf_loss_smapped)(
                    params, g_stack, ex, ew_stack, u, ip, ineg, w, k_d)
                updates, opt_state = opt.update(grads, opt_state)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                step, (params, opt_state), keys)
            return params, opt_state, jnp.sum(losses)

        # Pre-jitted (donation inside): callers must NOT re-jit on a
        # multi-host mesh — the wrapper passes the global stacked graph
        # through the jit boundary as an argument.
        def scan(params, opt_state, ew_stack, keys):
            return _scan(params, opt_state, pgraph, extra, ew_stack, keys)

        scan.pre_jitted = True
        return scan

    @jax.jit
    def _propagate_eval(g_stack, ex, ew_stack, params):
        if extra is not None:
            smapped = jax.shard_map(
                lambda g, e, p, rb: propagate_inner(g, e, p, None, False,
                                                    rb_stack=rb),
                mesh=mesh, in_specs=(P(AXIS), P(AXIS), P(), P(AXIS)),
                out_specs=P(), check_vma=False)
            return smapped(g_stack, ew_stack, params, ex)
        smapped = jax.shard_map(
            lambda g, e, p: propagate_inner(g, e, p, None, False),
            mesh=mesh, in_specs=(P(AXIS), P(AXIS), P()), out_specs=P(),
            check_vma=False)
        return smapped(g_stack, ew_stack, params)

    def propagate_eval(ew_stack, params):
        return _propagate_eval(pgraph, extra, ew_stack, params)

    return attention, propagate_eval, make_cf_step, make_cf_scan
