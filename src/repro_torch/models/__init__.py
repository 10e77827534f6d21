"""The port's language-model stack: Mamba-2 (``ssd``) blocks so far.

- layers: norms, embedding / unembedding, the matmul convention, init
- cache: the ``ssm`` decode cache, stacked layout, slot lifecycle
- ssm: the Mamba-2 block, its SSD on K6 (``kernels.ssd``)
- model: ``init_model`` and ``forward``
- convert: ``params_from_jax``, the reference's numpy tree -> the port's
"""
