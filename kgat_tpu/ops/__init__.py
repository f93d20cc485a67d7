"""Message-passing ops: the XLA reference path and the GPU SpMM kernel.

Replacement for DGL's native kernel core (SURVEY.md §2.2: g-SpMM
`src/array/cuda/spmm.cu`, g-SDDMM `src/array/cuda/sddmm.cu`, edge-softmax
`python/dgl/ops/edge_softmax.py`, segment-reduce
`src/array/*/segment_reduce.*` — all reconstructed locations, mount empty).

Two interchangeable backends with one surface (spmm / gspmm /
segment_softmax / sddmm_dot / segment_*):
  * ``ref``    — pure jnp/segment_sum implementations; the correctness
    oracle and the path on platforms without the kernel.
  * ``pallas`` — the CSR SpMM kernel (Pallas on Triton) for the GPU, with
    a custom VJP mirroring DGL's dual-op autograd structure (SpMM backward
    == SpMM on the reversed graph + an SDDMM for the weights); every other
    op is the reference one.

The model picks the backend from the platform (:func:`resolve_backend`),
not from a user flag.
"""

import jax

from kgat_tpu.ops import ref as _ref

BACKENDS = ("ref", "pallas")


def resolve_backend(name: "str | None" = None) -> str:
    """The ops backend to use: ``name`` when given, else the platform's
    own — the kernel on the GPU, the reference everywhere else."""
    if name is None:
        return "pallas" if jax.default_backend() == "gpu" else "ref"
    if name not in BACKENDS:
        raise ValueError(f"unknown ops backend: {name!r}")
    return name


def get_backend(name: "str | None" = None):
    if resolve_backend(name) == "pallas":
        from kgat_tpu.ops import pallas_backend as _pb
        return _pb
    return _ref
