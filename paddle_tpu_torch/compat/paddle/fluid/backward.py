"""paddle.fluid.backward — append_backward in the deferred-replay design
(counterpart of the JAX package's ``paddle/fluid/backward.py``).

Reference: python/paddle/fluid/backward.py:1337 append_backward builds
grad-op descs into the program. Here the backward is one
``backward()`` from the replayed loss inside ``Executor.run``, and
`optimizer.minimize(loss)` is what records the backward+update
directive — so append_backward's program-rewriting job does not exist
as a separate phase. The entry point is kept for scripts
that call it before minimize: it validates the loss is a graph output
and returns an empty param_grads list (grads are not separately
fetchable program variables; fetch parameters after the update instead).
"""
from __future__ import annotations

__all__ = ["append_backward"]


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    from paddle_tpu_torch.static.program import static_var

    if static_var(loss) is None:
        raise TypeError(
            "append_backward expects a static-graph loss (a fluid.data/"
            "layers output inside the default program)"
        )
    return []
