"""What the kernels' autograd Functions share to compose with ``torch.func``.

Each Function of ``ops`` is written in the ``forward`` + ``setup_context``
form, so ``torch.func.grad``, ``jacrev`` and ``vmap`` go through it as
``jax.grad`` and ``jax.vmap`` go through the JAX package's ``custom_vjp``s.
Under a transform ``forward`` receives plain tensors (a kernel can take
their ``data_ptr``), while ``backward`` receives the transform's wrapped
tensors: a backward calls kernels only through a Function (``_Trsm``'s
does, and ``kernel_function`` makes one), never through a launcher
directly.

A kernel takes one problem per launch (the batched TRSM takes a batch), so
a ``vmap`` rule is a loop over the batch that calls the same Function on
each entry (``vmap_loop``, and ``loop_vmap`` to give a Function that rule):
the kernel launches once per entry, on the same route as an unbatched call.
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


def loop_vmap(cls=None, *, pin=None):
    """Class decorator: the ``vmap`` rule of the Function ``cls`` is
    ``cls.apply`` on each entry of the batch (``vmap_loop``), its tensors
    made contiguous, other arguments passed as they are, but those at the
    positions in ``pin`` set to ``pin``'s values (never in place, say)."""
    if cls is None:
        return lambda c: loop_vmap(c, pin=pin)

    def entry(*args):
        return cls.apply(*[a.contiguous() if isinstance(a, torch.Tensor) else a for a in args])

    def vmap(info, in_dims, *args):
        if pin:
            args = [pin.get(i, a) for i, a in enumerate(args)]
        # a non-tensor argument's in_dims may be a tree of Nones (a tuple's)
        in_dims = [d if isinstance(a, torch.Tensor) else None for a, d in zip(args, in_dims)]
        return vmap_loop(entry, info, in_dims, *args)

    cls.vmap = staticmethod(vmap)
    return cls


def on_device(plain, cuda, at=0):
    """A call that runs ``plain`` when its argument at position ``at`` is a
    CPU tensor and ``cuda`` otherwise (where the kernel launches or
    raises; ``ops.linalg.kernels_active`` decides whether the kernels are
    wanted at all)."""

    def call(*args):
        return plain(*args) if args[at].device.type == "cpu" else cuda(*args)

    return call


def kernel_function(plain, cuda, at=0):
    """``on_device(plain, cuda, at)`` with ``cuda`` inside a Function with
    no backward and the loop ``vmap`` rule: a backward under a
    ``torch.func`` transform holds wrapped tensors, and only a Function's
    forward hands the kernel plain ones."""

    @loop_vmap
    class Kernel(torch.autograd.Function):
        @staticmethod
        def forward(*args):
            return cuda(*args)

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

    return on_device(plain, Kernel.apply, at)
