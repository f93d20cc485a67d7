"""kgat_tpu — a message-passing framework for the KGAT model family in JAX.

Built from scratch on JAX (XLA, Pallas on Triton, shard_map), with the
capabilities of the reference repo ``jennyzhang0215/DGL-KGAT`` (a
DGL/PyTorch implementation of KGAT, Wang et al., KDD 2019,
arXiv:1905.07854). See SURVEY.md for the layer map and the parity spec
this package implements.

Layer map (SURVEY.md §1, restated):
  kernels   -> kgat_tpu.ops            (XLA reference path + GPU SpMM kernel)
  graph     -> kgat_tpu.graph          (padded COO/CSR pytree, host builder)
  data      -> kgat_tpu.data           (dataset loaders, CKG construction)
  sampling  -> kgat_tpu.sampler        (host + device-side BPR/KG negatives)
  model     -> kgat_tpu.models.kgat    (pure apply fns over a param pytree)
  parallel  -> kgat_tpu.parallel       (edge partitioning, halo exchange, DP)
  driver    -> kgat_tpu.train / eval   (alternating-phase trainer, metrics)
  serving   -> kgat_tpu.recommend      (checkpoint -> masked top-K)
  analysis  -> kgat_tpu.explain        (attention-path explanations)
"""

__version__ = "0.1.0"

from kgat_tpu.graph import Graph, build_graph, build_ckg  # noqa: F401
