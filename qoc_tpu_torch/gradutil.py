"""Gradient utilities.

Counterpart of ``qoc_tpu/gradutil.py`` (reference
qoc/standard/utils/autogradutil.py:10-31): ``ans_jacobian(f, argnum)``
returns a function computing ``(value, jacobian)`` in one pass, one forward
and, for a real scalar output, one reverse sweep (what
``torch.func.grad_and_value`` runs), else one reverse sweep an output
element (``torch.func.vjp`` with a ``vmap`` over the basis).

The convention for complex inputs is ``qoc_tpu``'s (JAX's and autograd's):
for a real ``f`` of complex ``z = x + iy`` the gradient is du/dx - i du/dy,
and in general each Jacobian row is JAX's vjp of a real basis cotangent.
Torch's vjp is the conjugate of JAX's for a real cotangent, so rows with
respect to a complex input are conjugated.
"""

import torch

__all__ = ["ans_jacobian"]


def ans_jacobian(function, argnum=0):
    """Wrap ``function`` to return ``(value, jacobian)`` w.r.t. argument
    ``argnum``."""

    def wrapped(*args, **kwargs):
        wrt = args[argnum]

        def partial(x):
            new_args = list(args)
            new_args[argnum] = x
            return function(*new_args, **kwargs)

        value, vjp_fn = torch.func.vjp(partial, wrt)
        if value.dim() == 0 and not value.is_complex():
            # Real scalar: the gradient, torch.func.grad_and_value's sweep.
            jacobian, = vjp_fn(torch.ones_like(value))
        else:
            basis = torch.eye(value.numel(), dtype=value.dtype,
                              device=value.device)
            rows = torch.func.vmap(
                lambda e: vjp_fn(e.reshape(value.shape))[0])(basis)
            jacobian = rows.reshape(value.shape + wrt.shape)
        if wrt.is_complex():
            jacobian = jacobian.conj().resolve_conj()
        return value, jacobian

    return wrapped
