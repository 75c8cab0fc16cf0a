"""Gradients of a kernel through its plain version.

Where the JAX package's custom VJP differentiates the XLA oracle of a
Pallas kernel (``ops/warp.py``, ``ops/fused_stem.py``,
``ops/warp_onehot.py``), the port's ``torch.autograd.Function`` launches
the CUDA kernel in its forward and, in its backward, runs autograd through
the kernel's plain PyTorch version on the saved inputs: :func:`plain_vjp`.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch


def plain_vjp(plain: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor | None],
              needs: Sequence[bool], grad: torch.Tensor) -> tuple[torch.Tensor | None, ...]:
    """The vector-Jacobian product ``grad . d plain(*inputs) / d input`` for
    each input whose ``needs`` is set, None for the others (and for an input
    the output does not depend on). ``inputs`` may hold None for an
    optional argument of ``plain``."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(bool(n))
                  for t, n in zip(inputs, needs)]
        wrt = [t for t in leaves if t is not None and t.requires_grad]
        if not wrt:
            return tuple(None for _ in leaves)
        grads = iter(torch.autograd.grad(plain(*leaves), wrt, grad, allow_unused=True))
    return tuple(next(grads) if t is not None and t.requires_grad else None for t in leaves)


def needs_grad(*tensors: torch.Tensor | None) -> bool:
    """Whether autograd would record an op on ``tensors``: grad mode is on
    and one of them requires grad. The dispatchers launch a kernel through
    its ``torch.autograd.Function`` only then, so a serving call pays no
    autograd bookkeeping around a launch-sized kernel."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)
