"""The backward of a forward-only kernel: recompute through its plain
version and take that graph's gradients.

K5 and K6 are forward kernels, as the Pallas kernels they replace are; the
reference differentiates its model through the jnp versions.  Their
wrappers run as autograd functions on a CUDA tensor that needs a gradient,
and their backward calls ``plain_grads``.
"""
from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def plain_grads(plain: Callable, inputs: Sequence[torch.Tensor],
                needs: Sequence[bool], out_grads: Sequence
                ) -> Tuple:
    """Gradients of ``plain(*inputs)`` against ``out_grads`` (one for each
    output; None for an output that got none) for the inputs that
    ``needs`` marks, None for the others."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(bool(n))
               for t, n in zip(inputs, needs)]
        outs = plain(*ins)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, out_grads) if g is not None]
        wanted = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wanted,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in ins)
