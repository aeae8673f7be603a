"""Host-side checks of the serving stack's contracts: the allocator audit
(:func:`~repro_torch.analysis.aliasing.check_pool_consistency`), the
runtime sanitizer of the pool write path
(:mod:`~repro_torch.analysis.sanitize`, ``REPRO_SANITIZE=1``) and the
shape-ladder algebra (:mod:`~repro_torch.analysis.shapes`).  The JAX
package's jaxpr passes have no counterpart here."""
