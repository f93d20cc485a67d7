"""BPR-MF pretrainer: produces the --use-pretrain npz in-framework.

The reference workflow (SURVEY.md §2.1 pretrain-loader row; KGAT paper
§4.2 "pretrain") initializes KGAT's user/item embeddings from a matrix-
factorization model trained with the BPR loss. The reference repo only
*consumes* that npz (the original TF stack trained it separately); this
module closes the loop so the full paper recipe runs end-to-end here:

    python -m kgat_tpu.models.bprmf --dataset amazon-book --out mf.npz
    python -m kgat_tpu.train --dataset amazon-book --use-pretrain mf.npz

Device-resident shape: the whole training phase is a chunked ``lax.scan`` of
(device-side BPR sampling, score, Adam) steps — no host round trips, same
structure as the KGAT trainer's device-resident epochs.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax

from kgat_tpu.sampler import CFSampleTable, sample_cf_batch


def init_mf_params(rng: jax.Array, n_users: int, n_items: int,
                   dim: int = 64) -> dict:
    ku, ki = jax.random.split(rng)
    limit_u = float(np.sqrt(6.0 / (n_users + dim)))
    limit_i = float(np.sqrt(6.0 / (n_items + dim)))
    return {
        "user_embed": jax.random.uniform(ku, (n_users, dim), jnp.float32,
                                         -limit_u, limit_u),
        "item_embed": jax.random.uniform(ki, (n_items, dim), jnp.float32,
                                         -limit_i, limit_i),
    }


def bpr_loss(params: dict, u, i_pos, i_neg, weight, reg: float = 1e-5):
    """Weighted BPR loss + L2 (same convention as kgat.cf_loss)."""
    ue = params["user_embed"][u]
    pe = params["item_embed"][i_pos]
    ne = params["item_embed"][i_neg]
    diff = jnp.sum(ue * pe, -1) - jnp.sum(ue * ne, -1)
    n_valid = jnp.maximum(jnp.sum(weight), 1.0)
    loss = jnp.sum(-jax.nn.log_sigmoid(diff) * weight) / n_valid
    l2 = 0.5 * (jnp.sum(ue ** 2) + jnp.sum(pe ** 2) + jnp.sum(ne ** 2))
    return loss + reg * l2 / n_valid


def make_mf_scan(opt: optax.GradientTransformation, table: CFSampleTable,
                 batch_size: int):
    """Chunk-of-steps program: sampling + BPR step inside one lax.scan."""

    def scan(params, opt_state, keys):
        def step(carry, key):
            params, opt_state = carry
            u, ip, ineg, w = sample_cf_batch(table, key, batch_size)
            loss, grads = jax.value_and_grad(bpr_loss)(params, u, ip,
                                                       ineg, w)
            updates, opt_state = opt.update(grads, opt_state)
            return (optax.apply_updates(params, updates), opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), keys)
        return params, opt_state, jnp.mean(losses)

    return scan


def train_bprmf(cf_train: np.ndarray, n_users: int, n_items: int, *,
                dim: int = 64, lr: float = 1e-3, batch_size: int = 1024,
                epochs: int = 50, seed: int = 1234, chunk: int = 64,
                log=None) -> dict:
    """Train BPR-MF; returns {user_embed, item_embed} as numpy arrays."""
    table = CFSampleTable.build(cf_train, n_users, n_items)
    rng = jax.random.key(seed)
    rng, init = jax.random.split(rng)
    params = init_mf_params(init, n_users, n_items, dim)
    opt = optax.adam(lr)
    opt_state = opt.init(params)
    n_batches = max(len(cf_train) // batch_size + 1, 1)
    sizes = [chunk] * (n_batches // chunk)
    if n_batches % chunk:
        sizes.append(n_batches % chunk)
    # One jit suffices: it caches one executable per distinct chunk size.
    jitted = jax.jit(make_mf_scan(opt, table, batch_size),
                     donate_argnums=(0, 1))
    for epoch in range(1, epochs + 1):
        total = 0.0
        for s in sizes:
            rng, sub = jax.random.split(rng)
            params, opt_state, m = jitted(params, opt_state,
                                          jax.random.split(sub, s))
            total += float(m) * s
        if log is not None:
            log(epoch, total / n_batches)
    return {k: np.asarray(v) for k, v in params.items()}


def save_pretrain(path: str, embeds: dict) -> str:
    """Write the --use-pretrain npz (user_embed, item_embed keys)."""
    np.savez(path, user_embed=embeds["user_embed"],
             item_embed=embeds["item_embed"])
    return path


def main(argv=None) -> int:
    import argparse

    from kgat_tpu.train import load_any_dataset
    from kgat_tpu.utils.config import TrainConfig

    p = argparse.ArgumentParser(description="BPR-MF pretrainer")
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--data-root", default="datasets")
    p.add_argument("--out", default="mf_pretrain.npz")
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--seed", type=int, default=1234)
    a = p.parse_args(argv)

    cfg = TrainConfig(dataset=a.dataset, data_root=a.data_root)
    ds = load_any_dataset(cfg)
    embeds = train_bprmf(
        ds.cf_train, ds.n_users, ds.n_items, dim=a.dim, lr=a.lr,
        batch_size=a.batch_size, epochs=a.epochs, seed=a.seed,
        log=lambda e, l: print(f"epoch {e}: bpr_loss {l:.5f}", flush=True))
    save_pretrain(a.out, embeds)
    print(f"saved {a.out}: user_embed {embeds['user_embed'].shape} "
          f"item_embed {embeds['item_embed'].shape}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
