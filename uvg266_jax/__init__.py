"""uvg266-jax: a VVC (H.266) encoder whose search runs as JAX programs.

A from-scratch reimplementation of the capabilities of uvg266
(https://github.com/ultravideo/uvg266) for an accelerator (a GPU by default):

- The search runs as batched JAX/XLA programs: intra modes, CU lattice
  candidates, cost grids and transforms are batch dimensions, replacing
  uvg266's pthread job DAG (threadqueue.c).
- Entropy coding (CABAC) is an inherently sequential bitstream-exact pass that
  runs per-substream on the host, parallel across WPP rows / tiles / frames.
- Scale-out uses jax.sharding meshes (parallel/mesh.py): tile and closed-GOP
  sharding across devices; tiles break prediction, so no halo exchange.
"""

__version__ = "0.1.0"
