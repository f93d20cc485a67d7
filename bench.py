"""Benchmark: edges/s of the KGAT CF training step on one GPU.

Prints ONE JSON line:
  {"metric": "cf_step_edges_per_s", "value": N, "unit": "edges/s",
   "device": {...}, ...breakdown fields...}

Headline metric: full-graph CF training step throughput — (n_layers x E)
attention-weighted edge messages aggregated per second, including backward
and the Adam update (the hot loop of KGAT training, SURVEY.md §3.3). Also
reported: attention recompute (SDDMM + edge softmax) and pure forward
propagation.

The reference publishes no throughput numbers (SURVEY.md §6). With
--compare the same step also runs on the XLA reference path
(``ops_backend="ref"``) in this process, and vs_baseline is the platform
path's speedup over it.

Presets are synthetic graphs at the reference datasets' published scale
(KGAT paper Tab.1). Every time is taken on the host clock around work that
ends in block_until_ready. The benchmark measures a GPU only: on any other
platform it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

PRESETS = {
    # users, items, entities, relations, interactions, triples
    "smoke": (300, 200, 500, 8, 6_000, 4_000),
    "lastfm": (23_566, 48_123, 58_266, 9, 3_034_796, 464_567),
    "amazon-book": (70_679, 24_915, 88_572, 39, 847_733, 2_557_746),
    "yelp2018": (45_919, 45_538, 90_961, 42, 1_185_068, 1_853_704),
}


def build(preset: str, seed: int = 0, cache_dir: "str | None" = None):
    from kgat_tpu.data import synthetic_dataset

    u, i, e, r, inter, trip = PRESETS[preset]
    t0 = time.perf_counter()
    ds = synthetic_dataset(seed=seed, n_users=u, n_items=i, n_entities=e,
                           n_relations_kg=r, n_interactions=inter,
                           n_triples=trip, test_frac=0.1)
    t1 = time.perf_counter()
    graph, meta = ds.build(cache_dir=cache_dir)
    from kgat_tpu.graph import LAST_BUILD_STAGES
    LAST_BUILD_STAGES["dataset_gen_s"] = round(t1 - t0, 3)
    return ds, graph, meta


def timed_samples(fn, *args, iters=10, warmup=1):
    """Seconds per call of fn(*args), each ending in block_until_ready."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return np.asarray(ts)


def median_time(fn, *args, iters=10, warmup=1):
    return float(np.median(timed_samples(fn, *args, iters=iters,
                                         warmup=warmup)))


def _model_cfg(backend, compute_dtype: str):
    from kgat_tpu.models import kgat
    cd = jnp.bfloat16 if compute_dtype == "bf16" else None
    return kgat.KGATConfig(ops_backend=backend, compute_dtype=cd)


def bench_backend(graph, meta, backend, batch: int, iters: int,
                  compute_dtype: str = "f32"):
    from kgat_tpu.models import kgat

    cfg = _model_cfg(backend, compute_dtype)
    params = kgat.init_params(jax.random.key(0), meta.n_nodes,
                              meta.n_relations, cfg)
    E, L = graph.n_edges, len(cfg.conv_dims)

    attention = jax.jit(lambda p: kgat.attention_for_training(p, graph, cfg))
    t_att = median_time(attention, params, iters=iters)
    att = attention(params)

    forward = jax.jit(lambda p, a: kgat.propagate(p, graph, a, cfg))
    t_fwd = median_time(forward, params, att, iters=iters)

    opt = optax.adam(1e-4)
    opt_state = opt.init(params)
    u = jnp.arange(batch, dtype=jnp.int32) % meta.n_users
    ip = jnp.arange(batch, dtype=jnp.int32) % meta.n_items
    ineg = (jnp.arange(batch, dtype=jnp.int32) + 7) % meta.n_items

    @jax.jit
    def cf_step(params, opt_state, att):
        loss, grads = jax.value_and_grad(
            lambda p: kgat.cf_loss(p, graph, att, meta, u, ip, ineg, cfg,
                                   rng=jax.random.key(0), train=True))(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    def run_step():
        nonlocal params, opt_state
        params, opt_state, loss = cf_step(params, opt_state, att)
        return loss

    # Two back-to-back passes: their medians and spread go in the JSON so
    # a reader can tell a regression from run-to-run noise.
    n_step = max(iters, 20)
    s1 = timed_samples(run_step, iters=n_step)
    s2 = timed_samples(run_step, iters=n_step, warmup=0)
    all_s = np.concatenate([s1, s2])
    t_step = float(np.median(all_s))
    m1, m2 = float(np.median(s1)), float(np.median(s2))

    return {
        "t_attention_s": t_att,
        "t_forward_s": t_fwd,
        "t_cf_step_s": t_step,
        "t_cf_step_min_s": float(all_s.min()),
        "t_cf_step_pass_medians_s": (m1, m2),
        "cf_step_rerun_spread": abs(m1 - m2) / min(m1, m2),
        "attention_edges_per_s": E / t_att,
        "forward_edges_per_s": L * E / t_fwd,
        "cf_step_edges_per_s": L * E / t_step,
    }


def _exchange_bytes_per_layer(exchange: str, info, dims, dtype_bytes,
                              sel_halo=None):
    """Per-DEVICE bytes each propagation layer's exchange receives,
    computed from the partition statics.

    allgather: the all-gather of every peer's (R, d) activation block
      -> receive (P-1)*R*d; its AD transpose sends the same volume.
    ring: (P-1) neighbour shifts of the (R, d) chunk -> the same volume,
      overlapped with the bucket reduces.
    a2a: each device receives the (P-1)*H padded rows its edges reference
      (SelectiveHalo.halo_rows); the transpose sends the same.
    """
    P, R = info.n_parts, info.rows_per_part
    rows = sel_halo.halo_rows if exchange == "a2a" else R
    return [(P - 1) * rows * d * dtype_bytes for d in dims]


def bench_partitioned(ds, graph, meta, batch: int, iters: int,
                      n_devices: int, exchange: str, dp_replicas: int,
                      compute_dtype: str, t1_single: "float | None" = None):
    """Partitioned-path benchmark (SURVEY.md §6 scaling row): attention +
    CF step through the SAME machinery the trainer uses (partition_graph +
    make_partitioned) on an n-device mesh, with per-device edges/s and the
    exchange bytes each device receives per step."""
    from kgat_tpu.graph import host_coo
    from kgat_tpu.models import kgat
    from kgat_tpu.parallel.halo import AXIS, make_partitioned
    from kgat_tpu.parallel.partition import (build_ring_buckets,
                                             build_selective_halo,
                                             partition_graph)
    from kgat_tpu.sampler import CFSampleTable, sample_cf_batch

    cfg = _model_cfg(None, compute_dtype)
    params = kgat.init_params(jax.random.key(0), meta.n_nodes,
                              meta.n_relations, cfg)
    E, L = graph.n_edges, len(cfg.conv_dims)
    dp = max(1, dp_replicas)
    n_ep = n_devices // dp
    devs = jax.devices()[:n_devices]
    auto = jax.sharding.AxisType.Auto
    if dp > 1:
        mesh = jax.make_mesh((dp, n_ep), ("dp", AXIS),
                             axis_types=(auto, auto), devices=devs)
    else:
        mesh = jax.make_mesh((n_ep,), (AXIS,), axis_types=(auto,),
                             devices=devs)
    coo = host_coo(graph)
    pg, info = partition_graph(coo["src"], coo["dst"], coo["etype"],
                               meta.n_nodes, meta.n_relations, n_ep,
                               mesh=mesh)
    rb = sh = None
    if exchange == "ring":
        rb = build_ring_buckets(coo["src"], coo["dst"], info, mesh=mesh)
    elif exchange == "a2a":
        sh = build_selective_halo(coo["src"], coo["dst"], info, mesh=mesh)
    attention, propagate_eval, make_cf_step, _ = make_partitioned(
        mesh, pg, info, meta, cfg, exchange=exchange, ring_buckets=rb,
        sel_halo=sh, dp_axis="dp" if dp > 1 else None)

    t_att = median_time(lambda p: attention(pg, p), params, iters=iters)
    _, ew = attention(pg, params)
    t_prop = median_time(propagate_eval, ew, params, iters=iters)

    opt = optax.adam(1e-4)
    opt_state = opt.init(params)
    table = CFSampleTable.build(ds.cf_train, meta.n_users, meta.n_items)
    u, ip, ineg, w = sample_cf_batch(table, jax.random.key(1), batch)
    step = make_cf_step(opt)

    def run_step():
        nonlocal params, opt_state
        params, opt_state, loss = step(params, opt_state, ew, u, ip, ineg,
                                       w, jax.random.key(2))
        return loss

    ps1 = timed_samples(run_step, iters=max(iters, 20))
    ps2 = timed_samples(run_step, iters=max(iters, 20), warmup=0)
    t_step = float(np.median(np.concatenate([ps1, ps2])))
    m1, m2 = float(np.median(ps1)), float(np.median(ps2))

    dims = [cfg.embed_dim] + list(cfg.conv_dims[:-1])
    dtype_bytes = 2 if compute_dtype == "bf16" else 4
    per_layer = _exchange_bytes_per_layer(exchange, info, dims, dtype_bytes,
                                          sel_halo=sh)
    return {
        "partitioned": {
            "n_devices": n_devices,
            "n_ep": n_ep,
            "dp_replicas": dp,
            "exchange": exchange,
            "t_cf_step_ms": t_step * 1e3,
            "cf_step_spread_pct": abs(m1 - m2) / min(m1, m2) * 100,
            "t_attention_ms": t_att * 1e3,
            "t_propagate_ms": t_prop * 1e3,
            **({"vs_single_cf_step": t_step / t1_single}
               if t1_single else {}),
            "cf_step_edges_per_s": L * E / t_step,
            "cf_step_edges_per_s_per_device": L * E / t_step / n_devices,
            # forward exchange + its AD transpose, per layer
            "exchange_bytes_per_step_per_device": 2 * sum(per_layer),
        }
    }


def bench_serving(graph, meta, iters: int, block: int = 2048, k: int = 20,
                  compute_dtype: str = "f32"):
    """Serving-path throughput (kgat_tpu.recommend hot loop).

    One jitted forward is amortized across requests; at volume the cost is
    blocked scoring: (block, D) @ (D, n_items), train-mask, top-K. Reports
    the forward latency and the steady-state scoring rate in users/s.
    """
    from kgat_tpu.models import kgat
    from kgat_tpu.recommend import Recommender, _forward, _score_block

    cfg = _model_cfg(None, compute_dtype)
    params = kgat.init_params(jax.random.key(0), meta.n_nodes,
                              meta.n_relations, cfg)
    t_fwd = median_time(lambda p: _forward(cfg, p, graph), params,
                        iters=iters)
    # The serving API caches this forward across recommend() calls; the
    # steady-state per-request cost is the blocked score+top-K below.
    all_embed = Recommender(params, graph, meta, cfg).all_embed
    user_nodes = jnp.asarray(
        meta.user_node(np.arange(block) % meta.n_users), jnp.int32)
    mask = jnp.asarray(np.full((8, 2), [block, 0], np.int32))  # dead pairs
    t_score = median_time(
        lambda e, un: _score_block(e, un, mask, int(meta.n_items), k),
        all_embed, user_nodes, iters=iters)
    return {
        "serving_users_per_s": block / t_score,
        "serving_t_forward_ms": t_fwd * 1e3,
        "serving_t_score_block_ms": t_score * 1e3,
        "serving_block": block,
        "serving_k": k,
    }


def _card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="yelp2018", choices=sorted(PRESETS))
    p.add_argument("--compare", action="store_true",
                   help="also run the XLA reference path and report the "
                        "speedup over it")
    p.add_argument("--serving", action="store_true",
                   help="also measure the recommend path (users/s of "
                        "blocked masked top-K scoring)")
    p.add_argument("--n-devices", type=int, default=0,
                   help="also bench the PARTITIONED path over this many "
                        "devices")
    p.add_argument("--dp-replicas", type=int, default=1)
    p.add_argument("--halo-exchange", default="allgather",
                   choices=["allgather", "ring", "a2a"])
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--iters", type=int, default=10,
                   help="timing samples per stage; the headline cf_step "
                        "always runs TWO back-to-back passes of "
                        "max(iters, 20) samples each")
    p.add_argument("--compute-dtype", default="f32", choices=["f32", "bf16"],
                   help="SpMM feature-stream dtype of the GPU kernel")
    p.add_argument("--graph-cache", default="runs/gcache", metavar="DIR",
                   help="graph npz cache dir ('' disables)")
    a = p.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: measures a GPU only; JAX found {dev.platform!r}")
    from kgat_tpu.ops import resolve_backend
    from kgat_tpu.utils.cache import enable_compile_cache
    enable_compile_cache()
    backend = resolve_backend()
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices()), "card": _card()}
    print(f"# bench on {device} preset={a.preset} backend={backend}",
          file=sys.stderr)
    t0 = time.time()
    ds, graph, meta = build(a.preset, cache_dir=a.graph_cache or None)
    from kgat_tpu.graph import LAST_BUILD_STAGES
    print(f"# built graph: {meta.n_nodes} nodes {graph.n_edges} edges "
          f"{meta.n_relations} relations in {time.time()-t0:.1f}s "
          f"stages={json.dumps(LAST_BUILD_STAGES)}", file=sys.stderr)

    res = bench_backend(graph, meta, backend, a.batch, a.iters,
                        compute_dtype=a.compute_dtype)
    out = {
        "metric": "cf_step_edges_per_s",
        "value": res["cf_step_edges_per_s"],
        "unit": "edges/s",
        "preset": a.preset,
        "backend": backend,
        "compute_dtype": a.compute_dtype,
        "device": device,
        "n_edges": graph.n_edges,
        "attention_edges_per_s": res["attention_edges_per_s"],
        "forward_edges_per_s": res["forward_edges_per_s"],
        "t_cf_step_ms": res["t_cf_step_s"] * 1e3,
        "t_cf_step_min_ms": res["t_cf_step_min_s"] * 1e3,
        "t_cf_step_pass_medians_ms": [
            x * 1e3 for x in res["t_cf_step_pass_medians_s"]],
        "cf_step_spread_pct": res["cf_step_rerun_spread"] * 100,
        "graph_cache_state": LAST_BUILD_STAGES.get("graph_cache", "off"),
        "t_attention_ms": res["t_attention_s"] * 1e3,
        "t_forward_ms": res["t_forward_s"] * 1e3,
    }
    if a.compare and backend != "ref":
        ref = bench_backend(graph, meta, "ref", a.batch, a.iters)
        out.update({
            "vs_baseline": res["cf_step_edges_per_s"]
            / ref["cf_step_edges_per_s"],
            "ref_t_cf_step_ms": ref["t_cf_step_s"] * 1e3,
            "ref_t_attention_ms": ref["t_attention_s"] * 1e3,
            "ref_t_forward_ms": ref["t_forward_s"] * 1e3,
        })
    if a.n_devices > 0:
        out.update(bench_partitioned(
            ds, graph, meta, a.batch, a.iters, a.n_devices,
            a.halo_exchange, a.dp_replicas, a.compute_dtype,
            t1_single=res["t_cf_step_s"]))
    if a.serving:
        out.update(bench_serving(graph, meta, a.iters,
                                 compute_dtype=a.compute_dtype))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
