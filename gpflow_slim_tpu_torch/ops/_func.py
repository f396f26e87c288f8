"""What the kernels' autograd Functions share to compose with ``torch.func``.

Each Function of ``ops`` is written in the ``forward`` + ``setup_context``
form, so ``torch.func.grad``, ``jacrev`` and ``vmap`` go through it as
``jax.grad`` and ``jax.vmap`` go through the JAX package's ``custom_vjp``s.
Under a transform ``forward`` receives plain tensors (a kernel can take
their ``data_ptr``), while ``backward`` receives the transform's wrapped
tensors: a backward calls kernels only through a Function (``_Trsm``'s
does), never through a wrapper directly.

A kernel takes one problem per launch (the batched TRSM takes a batch), so
a ``vmap`` rule is a loop over the batch that calls the same Function on
each entry (``vmap_loop``): the kernel launches once per entry, on the
same route as an unbatched call.
"""

from __future__ import annotations

import torch


def transforms_active() -> bool:
    """True inside a ``torch.func`` transform (grad, vmap, jacrev, ...)."""
    return torch._C._are_functorch_transforms_active()


def vmap_loop(apply, info, in_dims, *args):
    """The ``vmap`` rule of a Function by a loop: ``apply(*entry)`` for each
    entry of the batch (an argument with ``in_dims`` None is shared), the
    outputs stacked along dimension 0."""
    args = [a if d is None else a.movedim(d, 0) for a, d in zip(args, in_dims)]
    outs = [apply(*[a if d is None else a[i] for a, d in zip(args, in_dims)]) for i in range(info.batch_size)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])
    return torch.stack(outs), 0
