"""Implementation dispatch.

Every op has an `xla` path (pure jax.numpy, runs anywhere).  The bilateral
family (bilateral, joint bilateral, and the JBF stage of the bilateral
texture filter) also has a `pallas` path: a Pallas-Triton GPU kernel
(ops/pallas/bilateral.py).

``resolve_impl`` turns the user's choice into the path that runs:

- ``"auto"`` → ``"pallas"`` on a `gpu` backend for ops that have a kernel,
  ``"xla"`` otherwise;
- ``"pallas"`` on an op without a kernel is an error, not a silent XLA run;
- ``"pallas"`` on a `cpu` backend (the test suite) → ``"interpret"``: the
  same kernel in Pallas interpret mode.  Nowhere else is the kernel
  interpreted.

The resolved string is a static argument of the jitted op, so a compiled
kernel and an interpreted one never share a trace.
"""

from __future__ import annotations

import jax

VALID_IMPLS = ("auto", "xla", "pallas")


def resolve_impl(impl: str, has_kernel: bool = True) -> str:
    if impl not in VALID_IMPLS:
        raise ValueError(f"impl must be one of {VALID_IMPLS}, got {impl!r}")
    backend = jax.default_backend()
    if impl == "auto":
        impl = "pallas" if has_kernel and backend == "gpu" else "xla"
    elif impl == "pallas" and not has_kernel:
        raise ValueError('this op has no Pallas kernel; use impl="xla" or '
                         '"auto"')
    if impl == "pallas" and backend == "cpu":
        return "interpret"
    return impl
