"""Device kernels: the XLA replacement of the reference's numba tier.

Every kernel is written dtype-generically against an array namespace ``xp``
(numpy for float64 host execution — the semantics-defining reference path,
analogous to the reference running its numba kernels with JIT disabled under
test — and jax.numpy for the jit-compiled XLA path used in production).
Parity between the two paths is asserted by tests/test_ops_parity.py.
"""

from . import bbox_ops, coarsen_ops, gather, rectify_ops, reproject_ops, srw

__all__ = [
    "bbox_ops",
    "coarsen_ops",
    "gather",
    "rectify_ops",
    "reproject_ops",
    "srw",
]
