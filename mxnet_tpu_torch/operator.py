"""``mx.operator`` — user-defined operators in Python, the port of
``mxnet_tpu/operator.py`` (MXNet's ``python/mxnet/operator.py``)::

    @mx.operator.register("sigmoid_like")
    class SigmoidProp(mx.operator.CustomOpProp):
        def list_arguments(self): return ["data"]
        def list_outputs(self): return ["output"]
        def infer_shape(self, in_shape): return in_shape, [in_shape[0]], []
        def create_operator(self, ctx, shapes, dtypes): return Sigmoid()

    out = mx.nd.Custom(x, op_type="sigmoid_like")

The user's ``forward`` and ``backward`` run on NDArrays inside one
``torch.autograd.Function`` (``autograd.Function``): under
``autograd.record()`` the user's ``backward`` is the op's gradient, even
where it disagrees with the forward (a straight-through estimator).
``assign`` honours ``req``: ``"write"``/``"inplace"`` overwrite, ``"add"``
accumulates, ``"null"`` leaves the destination.  Keyword arguments of
``nd.Custom`` reach the prop's ``__init__`` as strings, as MXNet passes
them through its C attribute dict.
"""

from __future__ import annotations

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]

_REGISTRY: dict = {}


class CustomOp:
    """Base of a user op's implementation."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` as ``req`` says."""
        if req in ("null", 0):
            return
        value = getattr(src, "_data", src)
        if req in ("add", 3):
            dst._set_data(dst._data + value)
        else:                                   # write, inplace
            dst._set_data(value)


class CustomOpProp:
    """A user op's metadata and factory."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = bool(need_top_grad)

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), \
            [in_type[0]] * len(self.list_auxiliary_states())

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError

    def need_top_grad(self):
        return self.need_top_grad_


def register(reg_name):
    """Register a ``CustomOpProp`` subclass under ``op_type=reg_name``."""
    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        if reg_name in _REGISTRY:
            raise MXNetError(f"custom op {reg_name!r} already registered")
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return deco


def get_all_registered():
    return sorted(_REGISTRY)


def _lookup(op_type):
    try:
        return _REGISTRY[op_type]
    except KeyError:
        raise MXNetError(f"custom op {op_type!r} is not registered "
                         f"(known: {sorted(_REGISTRY)})") from None


def invoke_custom(inputs, op_type, **kwargs):
    """``nd.Custom``: run the registered op, with the user's ``backward``
    as its gradient when recording."""
    from . import autograd
    from .ndarray import ndarray as _nd

    prop = _lookup(op_type)(**{k: str(v) for k, v in kwargs.items()})
    n_args = len(prop.list_arguments())
    if len(inputs) != n_args:
        raise MXNetError(f"custom op {op_type!r} expects {n_args} inputs "
                         f"({prop.list_arguments()}), got {len(inputs)}")
    in_shapes = [list(i.shape) for i in inputs]
    _, out_shapes, _ = prop.infer_shape(in_shapes)
    in_types = [i.dtype for i in inputs]
    _, out_types, _ = prop.infer_type(in_types)
    op = prop.create_operator(inputs[0].ctx, in_shapes, in_types)
    n_out = len(prop.list_outputs())
    is_train = autograd.is_training()

    class _Custom(autograd.Function):
        def forward(self, *ins):
            outs = [_nd.zeros(tuple(s), dtype=t, ctx=ins[0].ctx)
                    for s, t in zip(out_shapes, out_types)]
            op.forward(is_train=is_train, req=["write"] * n_out,
                       in_data=list(ins), out_data=outs, aux=[])
            self.save_for_backward(list(ins), outs)
            return outs[0] if n_out == 1 else tuple(outs)

        def backward(self, *ograds):
            ins, outs = self.saved_tensors
            igrads = [_nd.zeros(i.shape, dtype=i.dtype, ctx=i.ctx)
                      for i in ins]
            op.backward(req=["write"] * len(ins), out_grad=list(ograds),
                        in_data=ins, out_data=outs, in_grad=igrads, aux=[])
            return igrads[0] if len(igrads) == 1 else tuple(igrads)

    return _Custom()(*inputs)
