"""NDArray: MXNet's mutable tensor, over one ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  The reference keeps an
immutable ``jax.Array`` in a versioned slot and emulates views; torch
tensors are mutable and alias natively, so here:

- in-place writes (``a[:] = v``, ``a += 1``, ``out=``) write into the same
  tensor, and every alias and basic-index view sees them;
- basic indexing and ``reshape`` return views that write through;
  advanced indexing copies, and so does a read through a negative step
  (torch has no negative strides), while a write through one lands in
  the array itself;
- under ``autograd.record()`` ops are taped by torch autograd; an in-place
  write to an array that is the output of a recorded op raises
  ``MXNetError`` at the write (torch would fail only later, at backward).

A Python float or list becomes float32 (MXNet's ``mx_real_t``); a numpy
array keeps its dtype, float64 included.  ``save``/``load`` write and read
the reference's two ``.params`` containers (``npz`` and ``dmlc``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.utils.dlpack

from .. import config, dmlc_params
from ..base import MXNetError, mx_real_t, numpy_dtype, torch_dtype
from ..context import Context, context_of, current_context, resolve_device

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concat", "waitall", "save", "load", "from_numpy", "from_dlpack"]


def _invoke(name, inputs, attrs):
    from ..ops import registry
    return registry.invoke(registry.get(name), inputs, attrs)


class NDArray:
    """An n-dimensional array on a device: ``_data`` is its tensor,
    ``_grad`` its gradient buffer once ``attach_grad`` ran, ``_ctx`` the
    context it was placed on when that says more than its tensor's device
    (``cpu(1)``: torch has one host device, the reference's tests use
    several host contexts as data-parallel replicas)."""

    __slots__ = ("_data", "_grad", "grad_req", "_ctx", "__weakref__")
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None):
        self._data = data
        self._grad = None
        self.grad_req = "null"
        self._ctx = ctx

    # -- writes ---------------------------------------------------------------
    def _check_writable(self):
        from .. import autograd
        if autograd.is_recording() and self._data.grad_fn is not None:
            raise MXNetError(
                "in-place write to an array that is part of a recorded "
                "computation is not allowed inside autograd.record() "
                "(mutating recorded arrays invalidates the tape)")

    def _set_data(self, value):
        """Overwrite every element with ``value`` (broadcast, cast)."""
        with torch.no_grad():
            self._data.copy_(value)

    def _assign(self, t):
        """Take ``t`` as this array's value: a recorded ``t`` (one with a
        graph) is carried as is so gradients flow through it; anything
        else is written into the existing tensor."""
        if t.grad_fn is not None:
            self._data = t
        else:
            self._set_data(t)

    # -- properties -----------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def ctx(self):
        if self._ctx is not None:
            return self._ctx
        return context_of(self._data.device)

    context = ctx

    @property
    def stype(self):
        return "default"

    def tostype(self, stype):
        """This array in the storage type ``stype`` (``sparse.cast_storage``
        for ``row_sparse`` and ``csr``)."""
        if stype == "default":
            return self
        from . import sparse
        return sparse.cast_storage(self, stype)

    @property
    def grad(self):
        return self._grad

    # -- sync points ----------------------------------------------------------
    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    wait_to_write = wait_to_read

    def asnumpy(self):
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def __array__(self, dtype=None, copy=None):  # noqa: ARG002
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    # -- autograd -------------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):  # noqa: ARG002
        """Give this array a zero gradient buffer filled by ``backward``
        (``write`` overwrites it, ``add`` accumulates); it detaches the
        array from any recorded graph."""
        t = self._data if self._data.is_leaf else self._data.detach()
        self._data = t.requires_grad_(grad_req != "null")
        self.grad_req = grad_req
        self._grad = NDArray(torch.zeros_like(t, requires_grad=False),
                             self._ctx)

    def _accumulate_grad(self, g):
        if self._grad is None or self.grad_req == "null":
            return
        if g.grad_fn is not None:       # create_graph: keep g's graph
            self._grad = NDArray(g if self.grad_req == "write"
                                 else self._grad._data + g, self._ctx)
        elif self.grad_req == "write":
            self._grad._set_data(g)
        else:
            with torch.no_grad():
                self._grad._data.add_(g)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd
        autograd.backward([self], [out_grad], retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self):
        return NDArray(self._data.detach(), self._ctx)

    # -- device movement ------------------------------------------------------
    def as_in_context(self, ctx):
        if ctx == self.ctx:
            return self
        return self.copyto(ctx)

    as_in_ctx = as_in_context

    def copyto(self, other):
        if isinstance(other, NDArray):
            other._set_data(self._data.detach())
            return other
        if isinstance(other, Context):
            return _placed(self._data.detach().to(resolve_device(other),
                                                  copy=True), other)
        raise MXNetError(f"copyto does not support type {type(other)}")

    def copy(self):
        return NDArray(self._data.detach().clone(), self._ctx)

    def astype(self, dtype, copy=True):
        if not copy and torch_dtype(dtype) == self._data.dtype:
            return self
        return self._op1("cast", dtype=dtype)

    # -- op dispatch sugar ----------------------------------------------------
    def _op1(self, opname, **attrs):
        return _invoke(opname, [self], attrs)

    def _op2(self, opname, other, scalar_op, reverse=False):
        if isinstance(other, NDArray):
            return _invoke(opname, [other, self] if reverse else [self, other],
                           {})
        if isinstance(other, (int, float, bool, np.generic)):
            return _invoke(scalar_op, [self],
                           {"scalar": float(other), "reverse": reverse})
        return NotImplemented

    def __add__(self, o):
        return self._op2("broadcast_add", o, "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._op2("broadcast_sub", o, "_minus_scalar")

    def __rsub__(self, o):
        return self._op2("broadcast_sub", o, "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._op2("broadcast_mul", o, "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._op2("broadcast_div", o, "_div_scalar")

    def __rtruediv__(self, o):
        return self._op2("broadcast_div", o, "_div_scalar", reverse=True)

    def __mod__(self, o):
        return self._op2("broadcast_mod", o, "_mod_scalar")

    def __rmod__(self, o):
        return self._op2("broadcast_mod", o, "_mod_scalar", reverse=True)

    def __pow__(self, o):
        return self._op2("broadcast_power", o, "_power_scalar")

    def __rpow__(self, o):
        return self._op2("broadcast_power", o, "_power_scalar", reverse=True)

    def __neg__(self):
        return self._op1("negative")

    def __abs__(self):
        return self._op1("abs")

    def __eq__(self, o):
        if o is None:
            return False
        return self._op2("broadcast_equal", o, "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._op2("broadcast_not_equal", o, "_not_equal_scalar")

    def __lt__(self, o):
        return self._op2("broadcast_lesser", o, "_lesser_scalar")

    def __le__(self, o):
        return self._op2("broadcast_lesser_equal", o, "_lesser_equal_scalar")

    def __gt__(self, o):
        return self._op2("broadcast_greater", o, "_greater_scalar")

    def __ge__(self, o):
        return self._op2("broadcast_greater_equal", o,
                         "_greater_equal_scalar")

    __hash__ = object.__hash__

    # in-place operators write into the same tensor, so every alias and
    # view sees the result; an operand on the tape hands its graph on
    def _iop(self, opname, scalar_op, other):
        self._check_writable()
        self._assign(self._op2(opname, other, scalar_op)._data)
        return self

    def __iadd__(self, o):
        return self._iop("broadcast_add", "_plus_scalar", o)

    def __isub__(self, o):
        return self._iop("broadcast_sub", "_minus_scalar", o)

    def __imul__(self, o):
        return self._iop("broadcast_mul", "_mul_scalar", o)

    def __itruediv__(self, o):
        return self._iop("broadcast_div", "_div_scalar", o)

    # -- indexing -------------------------------------------------------------
    def _index(self, key):
        if isinstance(key, tuple):
            return tuple(self._index(k) for k in key)
        if isinstance(key, NDArray):
            return key._data.long()
        if isinstance(key, (list, np.ndarray)):
            return torch.as_tensor(np.asarray(key), device=self._data.device)
        return key

    def __getitem__(self, key):
        """Basic indexing gives a view that writes through; advanced
        indexing (arrays, lists) and a negative step a copy.  Recorded
        under record()."""
        from .. import autograd
        from ..ops.matrix import basic_index
        recording = autograd.is_recording()
        with torch.set_grad_enabled(recording):
            out = NDArray(basic_index(self._data, self._index(key)),
                          self._ctx)
        if recording:
            autograd._note_inputs([self])
        return out

    def __setitem__(self, key, value):
        self._check_writable()
        if isinstance(value, NDArray):
            value = value._data
        elif isinstance(value, (np.ndarray, list)):
            value = torch.as_tensor(np.asarray(value),
                                    device=self._data.device)
        from ..ops.matrix import basic_index
        with torch.no_grad():
            basic_index(self._data, self._index(key), value)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("The truth value of an NDArray with multiple "
                         "elements is ambiguous")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __repr__(self):
        return (f"\n{self.asnumpy()}\n<NDArray "
                f"{'x'.join(map(str, self.shape))} @{self.ctx}>")

    # -- shape manipulation ---------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """A view with MXNet's reshape codes (0, -1, -2, -3, -4)."""
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return self._op1("reshape", shape=tuple(kwargs.get("shape", shape)))

    def reshape_like(self, other):
        return self.reshape(other.shape)

    @property
    def T(self):
        return self._op1("transpose")

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return self._op1("transpose", axes=axes or None)

    def swapaxes(self, dim1, dim2):
        return self._op1("swapaxes", dim1=dim1, dim2=dim2)

    def flatten(self):
        return self._op1("flatten")

    def expand_dims(self, axis):
        return self._op1("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._op1("squeeze", axis=axis)

    def broadcast_to(self, shape):
        return self._op1("broadcast_to", shape=tuple(shape))

    def broadcast_like(self, other):
        return self.broadcast_to(other.shape)

    def tile(self, reps):
        return self._op1("tile", reps=(reps,) if isinstance(reps, int)
                         else tuple(reps))

    def repeat(self, repeats, axis=None):
        return self._op1("repeat", repeats=repeats, axis=axis)

    def flip(self, axis):
        return self._op1("flip", axis=axis)

    def slice(self, begin, end, step=None):
        return self._op1("slice", begin=tuple(begin), end=tuple(end),
                         step=tuple(step) if step else None)

    def slice_axis(self, axis, begin, end):
        return self._op1("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return _invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def pick(self, index, axis=-1, keepdims=False):
        return _invoke("pick", [self, index],
                       {"axis": axis, "keepdims": keepdims})

    def one_hot(self, depth, on_value=1.0, off_value=0.0):
        return self._op1("one_hot", depth=depth, on_value=on_value,
                         off_value=off_value)

    def _reduce(self, opname, axis, keepdims, **attrs):
        if isinstance(axis, list):
            axis = tuple(axis)
        return self._op1(opname, axis=axis, keepdims=keepdims, **attrs)

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):  # noqa: A002
        return self._reduce("norm", axis, keepdims, ord=ord)

    def argmax(self, axis=None, keepdims=False):
        return self._op1("argmax", axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._op1("argmin", axis=axis, keepdims=keepdims)

    def sort(self, axis=-1, is_ascend=True):
        return self._op1("sort", axis=axis, is_ascend=is_ascend)

    def argsort(self, axis=-1, is_ascend=True):
        return self._op1("argsort", axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return self._op1("topk", axis=axis, k=k, ret_typ=ret_typ,
                         is_ascend=is_ascend)

    def abs(self):
        return self._op1("abs")

    def sqrt(self):
        return self._op1("sqrt")

    def square(self):
        return self._op1("square")

    def exp(self):
        return self._op1("exp")

    def log(self):
        return self._op1("log")

    def relu(self):
        return self._op1("relu")

    def sigmoid(self):
        return self._op1("sigmoid")

    def tanh(self):
        return self._op1("tanh")

    def softmax(self, axis=-1):
        return self._op1("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._op1("log_softmax", axis=axis)

    def clip(self, a_min, a_max):
        return self._op1("clip", a_min=a_min, a_max=a_max)

    def dot(self, other, **kw):
        return _invoke("dot", [self, other], kw)

    def zeros_like(self):
        return NDArray(torch.zeros_like(self._data, requires_grad=False))

    def ones_like(self):
        return NDArray(torch.ones_like(self._data, requires_grad=False))

    def to_dlpack_for_read(self):
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    to_dlpack_for_write = to_dlpack_for_read


# --------------------------------------------------------------------------
# creation
# --------------------------------------------------------------------------

def _device(ctx):
    return resolve_device(ctx if ctx is not None else current_context())


def _placed(t, ctx):
    """An NDArray over ``t`` that remembers ``ctx`` where the tensor's
    device does not tell it (a host context other than ``cpu(0)``)."""
    if ctx is None or not isinstance(ctx, Context) \
            or ctx == context_of(t.device):
        return NDArray(t)
    return NDArray(t, ctx)


def array(source_array, ctx=None, dtype=None):
    """An NDArray holding a copy of ``source_array`` on ``ctx`` (the current
    context when None: the CUDA card unless ``with mx.cpu():``)."""
    dev = _device(ctx)
    if isinstance(source_array, NDArray):
        src = source_array._data.detach()
        return _placed(src.to(dev, src.dtype if dtype is None
                              else torch_dtype(dtype), copy=True), ctx)
    src = np.asarray(source_array)
    if dtype is None:
        dtype = src.dtype if isinstance(source_array, np.ndarray) \
            else mx_real_t
    if torch_dtype(dtype) == torch.bfloat16:
        return _placed(torch.as_tensor(src.astype(np.float32), device=dev)
                       .to(torch.bfloat16), ctx)
    return _placed(torch.as_tensor(src.astype(np.dtype(dtype), copy=True),
                                   device=dev), ctx)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype=None, **kwargs):  # noqa: ARG001
    return _placed(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)), ctx)


def ones(shape, ctx=None, dtype=None, **kwargs):  # noqa: ARG001
    return _placed(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)), ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def full(shape, val, ctx=None, dtype=None):
    return _placed(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)), ctx)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, dtype=torch_dtype(dtype),
                     device=_device(ctx))
    if repeat != 1:
        t = torch.repeat_interleave(t, repeat)
    return NDArray(t)


def concat(*arrays, dim=1):
    return _invoke("concat", list(arrays), {"dim": dim})


def from_numpy(a, zero_copy=False):  # noqa: ARG001
    """An NDArray holding a copy of numpy ``a`` on the current context."""
    return array(a)


def from_dlpack(capsule):
    """An NDArray over the tensor a DLPack capsule (or an object with
    ``__dlpack__``) describes, on its device, without a copy."""
    return NDArray(torch.utils.dlpack.from_dlpack(capsule))


def waitall():
    """Wait for all pending device work (``engine.waitall``)."""
    from .. import engine
    engine.waitall()


_SAVE_MAGIC = "mxnet_tpu.params.v1"


def _file_array(a):
    """An NDArray's value as numpy for a params file; bfloat16, which numpy
    lacks, as its raw bits in a 2-byte void, the bytes the reference's npz
    holds for it."""
    t = a._data.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_file(arr, ctx):
    """A params file's numpy array as an NDArray on ``ctx``; a 2-byte void
    is bfloat16 (the only dtype either package's npz stores that way)."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return NDArray(t.view(torch.bfloat16).to(_device(ctx), copy=True))
    return array(arr, ctx=ctx)


def save(fname, data, format=None):  # noqa: A002 (the reference's keyword)
    """Save an NDArray, a list or a dict of NDArrays to ``fname``.

    ``format="npz"`` (the default, ``MXNET_PARAMS_FORMAT``) is the
    reference's numpy container: a ``__magic__`` entry and ``name:<key>``
    or ``idx:<i>`` entries, bfloat16 as raw 2-byte voids.  ``"dmlc"`` is
    upstream MXNet's ``.params`` byte layout (``dmlc_params``), which has
    no bfloat16.  :func:`load` tells the two apart."""
    if format is None:
        format = config.get("MXNET_PARAMS_FORMAT")
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names, arrays = list(data), list(data.values())
    elif isinstance(data, (list, tuple)):
        names, arrays = None, list(data)
    else:
        raise MXNetError("save expects NDArray, list or dict of NDArrays")
    arrays = [_file_array(a) for a in arrays]
    if format == "dmlc":
        with open(fname, "wb") as f:
            f.write(dmlc_params.save_bytes(arrays, names))
        return
    if format != "npz":
        raise MXNetError(f"unknown params format {format!r}: npz or dmlc")
    payload = {"__magic__": np.frombuffer(_SAVE_MAGIC.encode(),
                                          dtype=np.uint8)}
    if names is None:
        payload.update((f"idx:{i:08d}", a) for i, a in enumerate(arrays))
    else:
        payload.update(("name:" + k, a) for k, a in zip(names, arrays))
    with open(fname, "wb") as f:
        np.savez(f, **payload)


def load(fname, ctx=None):
    """Load what :func:`save` (or the reference's ``mx.nd.save``, or
    upstream MXNet's ``.params`` writer) wrote: a dict by name, or a list,
    on ``ctx``."""
    with open(fname, "rb") as f:
        head = f.read(8)
    if dmlc_params.is_dmlc_params(head):
        with open(fname, "rb") as f:
            arrays, names = dmlc_params.load_bytes(f.read())
        if names:
            return {n: _from_file(a, ctx) for n, a in zip(names, arrays)}
        return [_from_file(a, ctx) for a in arrays]
    with np.load(fname, allow_pickle=False) as z:
        keys = [k for k in z.files if k != "__magic__"]
        if keys and keys[0].startswith("name:"):
            return {k[len("name:"):]: _from_file(z[k], ctx)
                    for k in sorted(keys)}
        return [_from_file(z[k], ctx) for k in sorted(keys)]
