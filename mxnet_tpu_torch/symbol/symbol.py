"""Symbol: the lazy computation-graph API, the port of
``mxnet_tpu/symbol/symbol.py`` (MXNet's ``python/mxnet/symbol/symbol.py``
over nnvm's Symbol and Graph).

A ``Symbol`` is a plain Python DAG over the same operator registry the
imperative path uses (``ops/registry.py``).  ``bind``/``simple_bind``
give an ``Executor`` (``executor.py``) that evaluates the graph node by
node on ``torch.Tensor``s, with torch autograd for the backward; the
reference lowers the whole graph into one ``jax.jit`` instead.
``infer_shape`` runs each node on ``meta`` tensors (shapes and dtypes,
no data, no kernel), where the reference calls ``jax.eval_shape``;
per-op ``infer_args`` rules fill the parameters' shapes from the data's,
so ``simple_bind`` needs only the data and label shapes.

The json written by ``tojson`` is the reference's ``"mxnet_tpu.sym.v1"``
(nodes in the same order, attributes as ``repr`` strings), so a file
written by either package loads in the other; node names come from the
same ``NameManager`` counters.
"""

from __future__ import annotations

import ast
import json

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..context import current_context
from .. import ndarray as nd
from ..ndarray.ndarray import NDArray
from ..ops import registry as _reg

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json",
           "zeros", "ones", "register_backend"]

# name -> pass fn(symbol, args, aux, **kwargs) -> symbol (sym.optimize_for)
_BACKEND_REGISTRY: dict = {}


def register_backend(name):
    """Register a graph-rewrite backend for ``sym.optimize_for(name)``."""
    def deco(fn):
        _BACKEND_REGISTRY[str(name)] = fn
        return fn
    return deco


def _identity_pass(sym, args=None, aux=None, **kwargs):  # noqa: ARG001
    return sym


# the reference's identity backends, kept by name so that scripts and files
# naming them still work: operator fusion and memory planning are left to
# torch and the hand-written kernels
for _n in ("default", "TPU", "xla"):
    _BACKEND_REGISTRY[_n] = _identity_pass


@register_backend("INT8")
def _int8_pass(sym, args=None, aux=None, **kwargs):  # noqa: ARG001
    raise MXNetError("optimize_for('INT8') (the int8 FullyConnected "
                     "rewrite) is not yet ported to mxnet_tpu_torch: it "
                     "waits with quantization (ROADMAP A.10)")


class Symbol:
    def __init__(self, op=None, inputs=(), attrs=None, name=None,
                 num_outputs=1, out_index=None):
        self._op = op                  # None for a variable; "group"
        self._inputs = list(inputs)
        self._attrs = dict(attrs or {})
        self._name = name or (op.name if op else "var")
        self._num_outputs = num_outputs
        self._out_index = out_index    # int when slicing one output

    # -- introspection -------------------------------------------------------
    @property
    def name(self):
        return self._name

    def attr(self, key):
        return self._attrs.get(key)

    def _set_attr(self, **kwargs):
        self._attrs.update(kwargs)

    def list_attr(self):
        return {k: str(v) for k, v in self._attrs.items()}

    def _walk(self):
        """Every node this one reads, inputs before their readers, each
        once (depth first, inputs in order: the reference's order)."""
        seen, order = {id(self)}, []
        stack = [(self, 0)]
        while stack:
            s, i = stack.pop()
            if i < len(s._inputs):
                stack.append((s, i + 1))
                child = s._inputs[i]
                if id(child) not in seen:
                    seen.add(id(child))
                    stack.append((child, 0))
            else:
                order.append(s)
        return order

    def list_arguments(self):
        return [s._name for s in self._walk()
                if s._op is None and not s._attrs.get("__aux__")]

    def list_auxiliary_states(self):
        return [s._name for s in self._walk()
                if s._op is None and s._attrs.get("__aux__")]

    def list_inputs(self):
        return [s._name for s in self._walk() if s._op is None]

    def list_outputs(self):
        if self._op == "group":
            return [o for i in self._inputs for o in i.list_outputs()]
        return [f"{self._name}_output"]

    @property
    def num_outputs(self):
        if self._op == "group":
            return sum(i.num_outputs for i in self._inputs)
        return 1 if self._out_index is not None else self._num_outputs

    def __getitem__(self, index):
        if isinstance(index, str):
            # internals["fc2_output"] selects the node named "fc2"
            base = index[:-7] if index.endswith("_output") else index
            pool = self._inputs if self._op == "group" else self._walk()
            for s in pool:
                if s._name in (base, index):
                    return s
            raise MXNetError(f"no internal symbol named {index!r}")
        if self._op == "group":
            return self._inputs[index]
        if isinstance(index, int):
            if self._num_outputs == 1 and index == 0:
                return self
            return Symbol("output_slice", [self], {"index": index},
                          name=f"{self._name}[{index}]")
        raise MXNetError("symbol indexing requires an int or name")

    def get_internals(self):
        return Group(*[s for s in self._walk() if s._op is not None])

    def get_children(self):
        return Group(*self._inputs) if self._inputs else None

    # -- composition ---------------------------------------------------------
    def _binop(self, opname, other, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            ins = [other, self] if reverse else [self, other]
            return _make(opname, ins, {})
        return _make(scalar_op, [self],
                     {"scalar": float(other), "reverse": reverse})

    def __add__(self, o):
        return self._binop("broadcast_add", o, "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop("broadcast_sub", o, "_minus_scalar")

    def __rsub__(self, o):
        return self._binop("broadcast_sub", o, "_minus_scalar", True)

    def __mul__(self, o):
        return self._binop("broadcast_mul", o, "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop("broadcast_div", o, "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop("broadcast_div", o, "_div_scalar", True)

    def __pow__(self, o):
        return self._binop("broadcast_power", o, "_power_scalar")

    def __neg__(self):
        return _make("negative", [self], {})

    def reshape(self, shape):
        return _make("reshape", [self], {"shape": tuple(shape)})

    def transpose(self, axes=None):
        return _make("transpose", [self], {"axes": axes})

    # -- evaluation ----------------------------------------------------------
    def _is_op(self):
        return self._op is not None and self._op not in ("group",
                                                         "output_slice")

    def _visible_head(self, main):
        """A multi-output head cut to its visible outputs (BatchNorm shows
        1 of its 3)."""
        if self._is_op() and isinstance(main, tuple) \
                and self._op.visible_outputs is not None:
            vis = main[:self._op.visible_outputs]
            return vis[0] if len(vis) == 1 else vis
        return main

    def _leaf_syms(self):
        return [s for s in self._walk() if s._op is None]

    def _graph_fn(self, train_mode=False, collect_mutations=False):
        """``(run, leaves, mut_specs)``: ``run(tensors, device)`` evaluates
        the graph on one tensor per leaf (``leaves``' order) and returns
        ``(head, mutated)``.

        ``train_mode`` is each op's ``wrap_train`` flag (Dropout,
        BatchNorm); an op with ``wrap_key`` draws from ``device``'s
        generator.  With ``collect_mutations``, ``mutated`` holds the new
        values of the variables an op writes (BatchNorm's moving
        statistics), one per ``mut_specs`` entry ``(leaf_name, node,
        out_idx)``."""
        order = self._walk()
        leaves = [s for s in order if s._op is None]
        mut_specs = []
        if collect_mutations:
            for s in order:
                if s._is_op():
                    for oi, ii in s._op.mutate_inputs:
                        tgt = s._inputs[ii]
                        if tgt._op is None:
                            mut_specs.append((tgt._name, s, oi))

        def run(tensors, device=None):
            vals = {id(s): t for s, t in zip(leaves, tensors)}
            for s in order:
                if s._op is None:
                    continue
                if s._op == "group":
                    v = tuple(x for i in s._inputs
                              for x in _as_tuple(vals[id(i)]))
                elif s._op == "output_slice":
                    v = _as_tuple(vals[id(s._inputs[0])])[s._attrs["index"]]
                else:
                    # a multi-output producer feeds its first output unless
                    # sliced (nnvm's entries)
                    ins = [_first(vals[id(i)]) for i in s._inputs]
                    attrs = _op_attrs(s)
                    if s._op.wrap_train is not None:
                        attrs[s._op.wrap_train] = train_mode
                    v = _reg.invoke_arrays(s._op, ins, attrs, device)
                    if isinstance(v, list):
                        v = tuple(v)
                vals[id(s)] = v
            head = self._visible_head(vals[id(self)])
            muts = tuple(_as_tuple(vals[id(node)])[oi]
                         for (_, node, oi) in mut_specs)
            return head, muts

        return run, leaves, mut_specs

    def eval(self, ctx=None, **kwargs):
        """The graph's outputs on ``ctx``: when None, the context of the
        first NDArray input, else the current one (the card unless
        ``with mx.cpu():``).  Every input is moved there first."""
        run, leaves, _ = self._graph_fn()
        vals = []
        for s in leaves:
            if s._name not in kwargs:
                raise MXNetError(f"eval missing argument {s._name!r}")
            vals.append(kwargs[s._name])
        if ctx is None:
            ctx = next((v.ctx for v in vals if isinstance(v, NDArray)),
                       None) or current_context()
        device = nd.ndarray._device(ctx)
        tensors = [(v.as_in_context(ctx) if isinstance(v, NDArray)
                    else nd.array(v, ctx=ctx))._data for v in vals]
        with torch.no_grad():
            out, _ = run(tensors, device)
        return [NDArray(o, ctx) for o in _as_tuple(out)]

    def infer_shape(self, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)``, or three Nones when a
        shape stays unknown.

        Each node runs on ``meta`` tensors (shapes and dtypes only) after
        its ``infer_args`` rule filled the parameters' shapes, the role of
        nnvm's InferShape pass.  An op whose output shape depends on
        values raises ``MXNetError`` naming the node."""
        shape_of, dtype_of = {}, {}
        order = self._walk()
        for s in order:
            if s._op is None:
                shp = kwargs.get(s._name, s._attrs.get("__shape__"))
                shape_of[id(s)] = tuple(shp) if shp is not None else None
                dtype_of[id(s)] = _leaf_dtype(s)
        meta = torch.device("meta")
        for s in order:
            if s._op is None:
                continue
            if s._op == "group":
                outs = []
                for i in s._inputs:
                    v = shape_of.get(id(i))
                    outs.extend(v if isinstance(v, list) else [v])
                shape_of[id(s)] = outs
                continue
            if s._op == "output_slice":
                v = shape_of.get(id(s._inputs[0]))
                d = dtype_of.get(id(s._inputs[0]))
                idx = s._attrs["index"]
                shape_of[id(s)] = v[idx] if isinstance(v, list) else v
                dtype_of[id(s)] = d[idx] if isinstance(d, list) else d
                continue
            in_shapes = [_first_of(shape_of.get(id(i))) for i in s._inputs]
            if s._op.infer_args is not None and any(
                    sh is None for sh in in_shapes):
                filled = s._op.infer_args(in_shapes, _op_attrs(s))
                for i, sh in zip(s._inputs, filled):
                    if sh is not None and shape_of.get(id(i)) is None \
                            and i._op is None:
                        shape_of[id(i)] = tuple(sh)
                in_shapes = filled
            if any(sh is None for sh in in_shapes):
                return None, None, None
            metas = [torch.empty(tuple(sh), device=meta,
                                 dtype=_first_of(dtype_of[id(i)]))
                     for i, sh in zip(s._inputs, in_shapes)]
            try:
                out = _run_on_meta(s._op, metas, _op_attrs(s))
            except Exception as e:
                raise MXNetError(
                    f"infer_shape failed at node {s._name!r}: {e}") from e
            if isinstance(out, (tuple, list)):
                shape_of[id(s)] = [tuple(o.shape) for o in out]
                dtype_of[id(s)] = [o.dtype for o in out]
            else:
                shape_of[id(s)] = tuple(out.shape)
                dtype_of[id(s)] = out.dtype
        name2shape = {s._name: shape_of.get(id(s))
                      for s in order if s._op is None}
        head = shape_of.get(id(self))
        if isinstance(head, list):
            if self._is_op() and self._op.visible_outputs is not None:
                head = head[:self._op.visible_outputs]
            out_shapes = head
        else:
            out_shapes = [head]
        return ([name2shape[a] for a in self.list_arguments()], out_shapes,
                [name2shape[a] for a in self.list_auxiliary_states()])

    def infer_type(self, **kwargs):
        """``(arg_types, out_types, aux_types)``: every argument, the output
        and every auxiliary state take the first argument's type (given in
        ``kwargs``, else float32).  The reference returns no aux types
        (ROADMAP C.7)."""
        args = self.list_arguments()
        dt = kwargs.get(args[0], np.float32) if args else np.float32
        return ([dt] * len(args), [dt],
                [dt] * len(self.list_auxiliary_states()))

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):  # noqa: ARG002
        from .executor import Executor
        return Executor(self, ctx or current_context(), args, args_grad,
                        grad_req, aux_states)

    def simple_bind(self, ctx=None, grad_req="write", shared_arg_names=None,
                    shared_exec=None, **shapes):
        """An executor over zeros at the shapes ``infer_shape`` gives.  With
        ``shared_exec``, the arguments in ``shared_arg_names`` (and their
        gradients) and the auxiliary states are that executor's arrays
        where the shapes agree, as MXNet shares them between the buckets
        of one model."""
        arg_shapes, _, aux_shapes = self.infer_shape(**shapes)
        if arg_shapes is None:
            raise MXNetError("simple_bind could not infer all shapes; pass "
                             "every input shape")
        ctx = ctx or current_context()
        keep = set(shared_arg_names or ())
        pools = ({}, {}, {}) if shared_exec is None else (
            {k: v for k, v in shared_exec.arg_dict.items() if k in keep},
            {k: v for k, v in shared_exec.grad_dict.items() if k in keep},
            shared_exec.aux_dict)

        def alloc(pool, names, shapes_):
            return {n: pool[n] if n in pool and pool[n].shape == tuple(s)
                    else nd.zeros(s, ctx=ctx) for n, s in zip(names, shapes_)}

        names = self.list_arguments()
        args = alloc(pools[0], names, arg_shapes)
        args_grad = alloc(pools[1], names, arg_shapes) \
            if grad_req != "null" else None
        aux = alloc(pools[2], self.list_auxiliary_states(), aux_shapes)
        return self.bind(ctx, args, args_grad, grad_req, aux)

    def optimize_for(self, backend, args=None, aux=None, **kwargs):
        """Run the graph pass registered under ``backend``
        (``register_backend``); the built-in ``default``, ``TPU`` and
        ``xla`` return the graph as it is, ``INT8`` raises (quantization,
        ROADMAP A.10), an unknown name raises."""
        fn = _BACKEND_REGISTRY.get(str(backend))
        if fn is None:
            raise MXNetError(
                f"subgraph backend {backend!r} is not registered "
                f"(known: {sorted(_BACKEND_REGISTRY)}); register one with "
                "mxnet_tpu_torch.symbol.register_backend(name)(pass_fn)")
        return fn(self, args, aux, **kwargs)

    # -- serialization -------------------------------------------------------
    def tojson(self):
        """The graph as ``"mxnet_tpu.sym.v1"`` json: nodes inputs first,
        attributes as ``repr`` strings, the head last."""
        order = self._walk()
        idx = {id(s): i for i, s in enumerate(order)}
        nodes = []
        for s in order:
            nodes.append({
                "op": "null" if s._op is None else (
                    s._op if isinstance(s._op, str) else s._op.name),
                "name": s._name,
                "attrs": {k: repr(v) for k, v in s._attrs.items()},
                "inputs": [[idx[id(i)], 0, 0] for i in s._inputs],
            })
        return json.dumps({"format": "mxnet_tpu.sym.v1", "nodes": nodes,
                           "heads": [[len(order) - 1, 0, 0]]}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())

    def __repr__(self):
        return f"<Symbol {self._name}>"


def _as_tuple(v):
    if isinstance(v, tuple):
        return v
    if isinstance(v, list):
        return tuple(v)
    return (v,)


def _first(v):
    return v[0] if isinstance(v, (tuple, list)) else v


def _first_of(v):
    return v[0] if isinstance(v, list) else v


def _leaf_dtype(s):
    dt = s._attrs.get("__dtype__")
    return torch.float32 if dt is None else torch_dtype(dt)


def _run_on_meta(op, tensors, attrs):
    """``op`` on meta tensors through the registry's dispatch (amp's cast,
    promotion), with the training flag off; nothing is drawn."""
    if op.wrap_train is not None:
        attrs = dict(attrs, **{op.wrap_train: False})
    return _reg.invoke_arrays(op, tensors, attrs, torch.device("meta"))


def _op_attrs(s):
    """An op node's keyword arguments: its attributes but the
    ``__dunder__`` annotations (AttrScope, shapes, the aux marker)."""
    return {k: v for k, v in s._attrs.items() if not k.startswith("__")}


def _name_hint(opname):
    """The NameManager hint of an op, shared with ``register.py`` so that
    both ways of building a node name it alike."""
    return opname.split(".")[-1].lower()


def _make(opname, inputs, attrs, name=None):
    from ..attribute import AttrScope
    from ..name import NameManager
    op = _reg.get(opname)
    return Symbol(op, inputs, AttrScope.current().get(attrs),
                  name=NameManager.current().get(name, _name_hint(opname)))


def var(name, attr=None, shape=None, dtype=None, init=None, stype=None,
        **kwargs):  # noqa: ARG001
    from ..attribute import AttrScope
    s = Symbol(None, name=name)
    if shape is not None:
        s._attrs["__shape__"] = tuple(shape)
    if dtype is not None:
        s._attrs["__dtype__"] = dtype
    # scope attributes apply to variables too (lr_mult/wd_mult/ctx_group)
    merged = AttrScope.current().get(attr)
    if merged:
        s._attrs.update(merged)
    s._attrs.update(kwargs)
    return s


Variable = var


def Group(*symbols):
    if len(symbols) == 1 and isinstance(symbols[0], (list, tuple)):
        symbols = tuple(symbols[0])
    return Symbol("group", list(symbols), name="group")


def load_json(json_str):
    data = json.loads(json_str)
    built = []
    for n in data["nodes"]:
        attrs = {}
        for k, v in n.get("attrs", {}).items():
            try:
                attrs[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                attrs[k] = v
        ins = [built[i[0]] for i in n.get("inputs", [])]
        if n["op"] == "null":
            s = Symbol(None, name=n["name"], attrs=attrs)
        elif n["op"] in ("group", "output_slice"):
            s = Symbol(n["op"], ins, attrs, name=n["name"])
        else:
            s = Symbol(_reg.get(n["op"]), ins, attrs, name=n["name"])
        built.append(s)
    head = data.get("heads", [[len(built) - 1, 0, 0]])[0][0]
    return built[head]


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def zeros(shape, dtype=None, **kwargs):
    return _make("_zeros", [], {"shape": tuple(shape),
                                "dtype": dtype or "float32"}, **kwargs)


def ones(shape, dtype=None, **kwargs):
    return _make("_ones", [], {"shape": tuple(shape),
                               "dtype": dtype or "float32"}, **kwargs)
