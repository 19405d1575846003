"""Control flow over NDArrays — the port of ``mxnet_tpu/symbol/contrib.py``
(MXNet's ``contrib.foreach``/``while_loop``/``cond``).

The reference lowers them to ``lax.scan``, ``lax.while_loop`` and
``lax.cond``; here they are Python loops and branches over NDArray ops,
so autograd records the iterations that ran and differentiates through
them.  ``mx.sym.contrib`` holds these beside the generated
``contrib.*`` operators (in the reference the generated namespace
hides them, ROADMAP C.7).
"""

from __future__ import annotations

from .. import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ["foreach", "while_loop", "cond"]


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _like(template, items):
    """``items`` in the structure of ``template`` (a list, a tuple or one
    value)."""
    if isinstance(template, (list, tuple)):
        return type(template)(items)
    return items[0]


def _truth(p):
    if isinstance(p, NDArray):
        return bool(p.asnumpy().reshape(-1)[0])
    return bool(p)


def foreach(body, data, init_states):
    """Run ``body(data[i], states) -> (out, new_states)`` over axis 0 of
    ``data`` (an NDArray, or a list of them sliced together); returns the
    outputs stacked on axis 0 and the last states."""
    states = init_states
    steps = []
    for i in range(_as_list(data)[0].shape[0]):
        x = _like(data, [d[i] for d in _as_list(data)])
        out, states = body(x, states)
        steps.append(_as_list(out))
    stacked = [nd.stack(*col, axis=0) for col in zip(*steps)]
    return _like(out, stacked), states


def while_loop(cond_fn, func, loop_vars, max_iterations=None):
    """Apply ``func(*vars) -> (step_out, new_vars)`` while
    ``cond_fn(*vars)`` holds.  Without ``max_iterations`` only the
    variables evolve and ``([], vars)`` comes back; with it, exactly
    ``max_iterations`` steps run, each step's output is kept (a step
    after the condition failed sees the frozen variables) and the
    variables stop changing once the condition fails, as the reference's
    masked scan does."""
    loop_vars = list(loop_vars)
    if max_iterations is None:
        while _truth(cond_fn(*loop_vars)):
            _, loop_vars = func(*loop_vars)
            loop_vars = _as_list(loop_vars)
        return [], loop_vars
    active, steps = True, []
    for _ in range(max_iterations):
        pred = _truth(cond_fn(*loop_vars))
        step_out, new_vars = func(*loop_vars)
        steps.append(_as_list(step_out))
        active = active and pred
        if active:
            loop_vars = _as_list(new_vars)
    return [nd.stack(*col, axis=0) for col in zip(*steps)], loop_vars


def cond(pred, then_func, else_func, inputs=None):  # noqa: ARG001
    """``then_func()`` if ``pred`` (a value or a callable) holds, else
    ``else_func()``."""
    p = pred() if callable(pred) else pred
    return then_func() if _truth(p) else else_func()
