"""The port's language-model stack: attention, MoE, Mamba-2 and RG-LRU
blocks.

- layers: norms, embedding / unembedding, the matmul convention, init,
  RoPE, GQA attention (K5 through ``kernels.ops.attention``) and the MLP
- cache: the ``full``, ``ring``, ``ssm`` and ``rglru`` decode caches, the
  stacked layout, the slot lifecycle
- moe: the MoE FFN (router, experts as virtual sub-experts), its dense
  path and its expert-parallel a2a path over a grid of rank processes
- ssm: the Mamba-2 block, its SSD on K6 (``kernels.ssd``)
- rglru: the Griffin recurrent block
- model: ``init_model`` and ``forward``
- convert: ``params_from_jax``, the reference's numpy tree -> the port's
"""
