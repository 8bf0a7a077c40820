"""Symbolic graph construction: the port of ``mxnet_tpu/symbol.py``.

A Symbol is a list of heads over shared ``Node``s; composition
auto-creates variable nodes for unbound op arguments and auxiliary
states (the reference's Compose semantics).  Graph JSON save/load keeps
the reference's format byte for byte, so a graph written by either
package loads in the other (the two-artifact checkpoint: symbol JSON +
named parameter file).

Op-creating functions (``mx.sym.FullyConnected`` etc.) are generated
from the op registry at import time.  ``bind``/``simple_bind`` build an
:class:`~mxnet_tpu_torch.executor.Executor`; ``grad`` differentiates
the graph with torch autograd.
"""

from __future__ import annotations

import builtins
import json
import sys
import threading

import numpy as np

from .base import MXNetError, np_dtype, numeric_types
from .ops import OP_REGISTRY

__all__ = ["Symbol", "Variable", "Group", "load", "load_json", "AttrScope",
           "NameManager", "Prefix"]


class AttrScope:
    """Attribute scope propagated onto created symbols
    (python/mxnet/attribute.py; carries ctx_group / force_mirroring /
    lr_mult-style attrs)."""

    _current = threading.local()

    def __init__(self, **attrs):
        self._attrs = {k: str(v) for k, v in attrs.items()}
        self._old = None

    @classmethod
    def current_attrs(cls) -> dict:
        cur = getattr(cls._current, "value", None)
        return dict(cur._attrs) if cur is not None else {}

    def __enter__(self):
        self._old = getattr(AttrScope._current, "value", None)
        merged = dict(self._old._attrs) if self._old else {}
        merged.update(self._attrs)
        self._merged_attrs = self._attrs
        self._attrs = merged
        AttrScope._current.value = self
        return self

    def __exit__(self, *exc):
        self._attrs = self._merged_attrs
        AttrScope._current.value = self._old
        return False

    def get(self, attr):
        """Merge user-passed attrs over this scope's attrs (reference
        attribute.py:26-44): scope values are defaults, explicit symbol
        attrs win."""
        if self._attrs:
            ret = self._attrs.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}


class _NameGet:
    """``NameManager.get()`` (classmethod style) returns the current
    manager — this build's internal accessor; ``manager.get(name, hint)``
    (instance style) is the reference canonical-name API
    (python/mxnet/name.py:16): the user name wins, else an auto name
    from the hint."""

    def __get__(self, obj, objtype):
        if obj is None:
            return objtype._current_manager
        return obj._ref_get


class NameManager:
    """Automatic unique naming (python/mxnet/name.py)."""

    _current = threading.local()

    get = _NameGet()

    def __init__(self):
        self._counter = {}

    @classmethod
    def _current_manager(cls):
        if getattr(cls._current, "value", None) is None:
            cls._current.value = NameManager()
        return cls._current.value

    def next_name(self, hint: str) -> str:
        idx = self._counter.get(hint, 0)
        self._counter[hint] = idx + 1
        return f"{hint}{idx}"

    def _ref_get(self, name, hint):
        """Reference name.py:16-38 canonical-name rule: a truthy user
        name wins, else an auto name from the hint."""
        return name if name else self.next_name(hint)

    def __enter__(self):
        self._old = getattr(NameManager._current, "value", None)
        NameManager._current.value = self
        return self

    def __exit__(self, *exc):
        NameManager._current.value = self._old
        return False


class Prefix(NameManager):
    """NameManager that prepends a prefix to every auto name
    (python/mxnet/name.py Prefix)."""

    def __init__(self, prefix: str):
        super().__init__()
        self._prefix = prefix

    def next_name(self, hint: str) -> str:
        return self._prefix + super().next_name(hint)

    def _ref_get(self, name, hint):
        """Reference name.py:73-75: the prefix applies to USER names
        too (``super().get`` then prepend)."""
        if name:
            return self._prefix + name
        return self.next_name(hint)   # already prefixed


class Node:
    """One graph node: an op application or a variable (symbolic.h Node)."""

    __slots__ = ("op", "name", "attrs", "params", "inputs", "_id")

    def __init__(self, op, name, attrs=None, params=None, inputs=None):
        self.op = op  # OpDef or None for variables
        self.name = name
        self.attrs = dict(attrs or {})
        self.params = params
        self.inputs = list(inputs or [])  # [(Node, out_index)]

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        return 1 if self.is_variable else self.op.num_outputs(self.params)

    def __repr__(self):
        kind = "var" if self.is_variable else self.op.name
        return f"<Node {kind}:{self.name}>"


def _topo_order(head_nodes):
    """Post-order DFS over unique nodes (static_graph.cc topo sort)."""
    seen = set()
    order = []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for (src, _) in node.inputs:
            visit(src)
        order.append(node)

    for n in head_nodes:
        visit(n)
    return order


# (graph-head ids, wrt) -> registered grad-op name.  Bounded: grad ops
# close over their base graph, so unbounded registration would leak graphs
# when callers rebuild symbols per iteration; eviction only drops the
# registry entry — already-built grad symbols hold the op directly.
_GRAD_OP_CACHE = {}
_GRAD_OP_CACHE_MAX = 64


class Symbol:
    """A list of output heads over a shared node graph."""

    __slots__ = ("_heads",)

    def __init__(self, heads):
        self._heads = list(heads)  # [(Node, out_index)]

    # -- introspection -----------------------------------------------------
    @property
    def name(self):
        if len(self._heads) == 1:
            return self._heads[0][0].name
        return None

    def _topo(self):
        return _topo_order([n for n, _ in self._heads])

    def list_arguments(self):
        """Names of argument variables in topo order (symbolic.h:132).

        Auxiliary-state variables are excluded (they have the node attr
        ``__aux__``)."""
        return [n.name for n in self._topo()
                if n.is_variable and "__aux__" not in n.attrs]

    def list_outputs(self):
        out = []
        for node, idx in self._heads:
            if node.is_variable:
                out.append(node.name)
            else:
                out.append(f"{node.name}_{node.op.list_outputs(node.params)[idx]}")
        return out

    def list_auxiliary_states(self):
        return [n.name for n in self._topo()
                if n.is_variable and "__aux__" in n.attrs]

    def get_internals(self) -> "Symbol":
        """Symbol exposing every internal output (symbolic.h GetInternals)."""
        heads = []
        for node in self._topo():
            for i in range(node.num_outputs()):
                heads.append((node, i))
        return Symbol(heads)

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise ValueError(f"no output named {index!r}; outputs: {names}")
            index = names.index(index)
        return Symbol([self._heads[index]])

    def __len__(self):
        return len(self._heads)

    def __iter__(self):
        return (self[i] for i in range(len(self._heads)))

    # -- attributes --------------------------------------------------------
    def attr(self, key):
        if len(self._heads) == 1:
            return self._heads[0][0].attrs.get(key)
        return None

    def _set_attr(self, **kwargs):
        for node, _ in self._heads:
            node.attrs.update({k: str(v) for k, v in kwargs.items()})

    def attr_dict(self):
        out = {}
        for node in self._topo():
            if node.attrs:
                out[node.name] = dict(node.attrs)
        return out

    def list_attr(self, recursive=False):
        """All attributes of this symbol (reference symbol.py:255).

        ``recursive=True`` walks descendants with ``<node>_``-prefixed
        keys (MXSymbolListAttr); shallow returns only the head node's
        own attrs, un-prefixed (MXSymbolListAttrShallow)."""
        if not recursive:
            if len(self._heads) == 1:
                return dict(self._heads[0][0].attrs)
            return {}
        out = {}
        for node in self._topo():
            for k, v in node.attrs.items():
                out[f"{node.name}_{k}"] = v
        return out

    # -- composition -------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """Compose: bind this symbol's free variables to new inputs
        (symbolic.h Compose).  Returns a new Symbol; the graph is copied so
        the original stays reusable."""
        name = kwargs.pop("name", None)
        mapping = {}
        arg_names = self.list_arguments()
        if args:
            if kwargs:
                raise MXNetError("compose accepts positional or keyword args, not both")
            if len(args) > len(arg_names):
                raise MXNetError("too many positional arguments")
            for argname, sym in zip(arg_names, args):
                mapping[argname] = sym
        for k, v in kwargs.items():
            if k not in arg_names:
                raise MXNetError(f"unknown argument {k!r}; args: {arg_names}")
            mapping[k] = v
        copies = {}

        def copy_node(node):
            if id(node) in copies:
                return copies[id(node)]
            if node.is_variable and node.name in mapping:
                head_node, head_idx = mapping[node.name]._heads[0]
                if head_idx != 0:
                    # splice a pass-through of that output via _copy
                    new = Node(OP_REGISTRY.get("_copy"), node.name, {},
                               None, [(head_node, head_idx)])
                else:
                    new = head_node
            else:
                new = Node(node.op, node.name, node.attrs, node.params,
                           [(copy_node(s), i) for s, i in node.inputs])
            copies[id(node)] = new
            return new

        return Symbol([(copy_node(n), i) for n, i in self._heads])

    # -- shape / dtype inference -------------------------------------------
    def infer_shape(self, *args, **kwargs):
        return self._infer_shape_impl(False, *args, **kwargs)

    def infer_shape_partial(self, *args, **kwargs):
        return self._infer_shape_impl(True, *args, **kwargs)

    def _infer_shape_impl(self, partial, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, shp in zip(arg_names, args):
                if shp is not None:
                    known[name] = tuple(shp)
        for k, v in kwargs.items():
            if k not in arg_names and k not in self.list_auxiliary_states():
                raise MXNetError(f"infer_shape: unknown argument {k!r}")
            known[k] = tuple(v)
        shapes = _infer_graph(self._topo(), known, "shape", partial)
        if shapes is None:
            return None, None, None
        arg_shapes = [shapes["var", n] for n in arg_names]
        aux_shapes = [shapes["var", n] for n in self.list_auxiliary_states()]
        out_shapes = [shapes["out", id(n), i] for n, i in self._heads]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        arg_names = self.list_arguments()
        known = {}
        if args:
            for name, dt in zip(arg_names, args):
                if dt is not None:
                    known[name] = np_dtype(dt)
        for k, v in kwargs.items():
            known[k] = np_dtype(v)
        types = _infer_graph(self._topo(), known, "dtype", False)
        if types is None:
            return None, None, None
        arg_types = [types["var", n] for n in arg_names]
        aux_types = [types["var", n] for n in self.list_auxiliary_states()]
        out_types = [types["out", id(n), i] for n, i in self._heads]
        return arg_types, out_types, aux_types

    def grad(self, wrt):
        """Gradient symbol (reference symbol.py:859 `Symbol.grad` /
        `MXSymbolGrad` c_api.cc:770 -> Symbol::Grad).

        Only meaningful on loss symbols: returns a new Symbol with the
        same argument names whose outputs are d(loss)/d(arg) for each
        name in ``wrt`` (head gradients are ones, the loss-layer
        backward convention), by torch autograd over the graph.
        """
        from .ops.op import OpDef

        base = self
        wrt = [wrt] if isinstance(wrt, str) else list(wrt)
        arg_names = base.list_arguments()
        aux_names = base.list_auxiliary_states()
        for w in wrt:
            if w not in arg_names:
                raise MXNetError(
                    f"grad: {w!r} is not an argument of this symbol "
                    f"(arguments: {arg_names})")
        # one registered op per (graph head, wrt): repeated grad() calls
        # in a loop reuse it instead of growing the registry
        cache_key = (tuple((id(n), i) for n, i in self._heads), tuple(wrt))
        cached_name = _GRAD_OP_CACHE.get(cache_key)
        if cached_name is not None:
            bound = {a: Variable(a) for a in arg_names}
            return _create(cached_name, [], {**bound, "name": cached_name})
        has_rng = any(not n.is_variable and n.op.need_rng
                      for n in base._topo())

        class _GradOp(OpDef):
            need_rng = has_rng

            def __init__(self):
                self._graph = None

            def list_arguments(self, params):
                return list(arg_names)

            def list_outputs(self, params):
                return [f"{w}_grad" for w in wrt]

            def list_auxiliary_states(self, params):
                return list(aux_names)

            def infer_shape(self, params, in_shapes):
                known = {n: s for n, s in zip(arg_names, in_shapes)
                         if s is not None}
                arg_shapes, _, aux_shapes = base.infer_shape(**known)
                outs = [arg_shapes[arg_names.index(w)] for w in wrt]
                return list(arg_shapes), outs, list(aux_shapes)

            def infer_dtype(self, params, in_dtypes):
                ins, _, auxs = OpDef.infer_dtype(self, params, in_dtypes)
                return ins, [ins[arg_names.index(w)] for w in wrt], auxs

            def forward(self, params, inputs, aux, train, key):
                import torch

                from .executor import _GraphRunner

                if self._graph is None:
                    self._graph = _GraphRunner(base)
                graph = self._graph
                with torch.enable_grad():
                    arg_vals = dict(zip(arg_names, inputs))
                    leaves = [arg_vals[w].detach().requires_grad_(True)
                              for w in wrt]
                    arg_vals.update(zip(wrt, leaves))
                    aux_vals = dict(zip(aux_names, aux))
                    outs, _ = graph(arg_vals, aux_vals, key, train)
                    grads = torch.autograd.grad(
                        outs, leaves, [torch.ones_like(o) for o in outs],
                        allow_unused=True)
                grads = [torch.zeros_like(x) if g is None else g.detach()
                         for g, x in zip(grads, leaves)]
                return grads, list(aux)

        op = _GradOp()
        gname = f"_grad_{id(op):x}"
        op.name = gname
        op.serializable = False  # process-local closure over `base`
        OP_REGISTRY.register(gname, op)
        _GRAD_OP_CACHE[cache_key] = gname
        while len(_GRAD_OP_CACHE) > _GRAD_OP_CACHE_MAX:
            old_key = next(iter(_GRAD_OP_CACHE))
            OP_REGISTRY.remove(_GRAD_OP_CACHE.pop(old_key))
        bound = {a: Variable(a) for a in arg_names}
        return _create(gname, [], {**bound, "name": gname})

    # -- serialization (static_graph.cc:601-616 JSON contract) --------------
    def __reduce__(self):
        """Pickle via the JSON graph (reference symbol.py __getstate__:
        the handle is process-local; the graph is the state).  Lets
        objects that CARRY a symbol — an Optimizer created with
        ``sym=`` riding to a kvstore server, a checkpointed module —
        pickle without dragging registry lambdas along."""
        return (load_json, (self.tojson(),))

    def tojson(self) -> str:
        nodes = self._topo()
        for n in nodes:
            if not n.is_variable and not getattr(n.op, "serializable", True):
                raise MXNetError(
                    f"symbol contains process-local op {n.op.name!r} "
                    "(e.g. a Symbol.grad result) and cannot be serialized; "
                    "save the base symbol and re-derive the gradient after "
                    "loading")
        node_ids = {id(n): i for i, n in enumerate(nodes)}
        out_nodes = []
        for n in nodes:
            entry = {
                "op": "null" if n.is_variable else n.op.name,
                "name": n.name,
                "inputs": [[node_ids[id(s)], i] for s, i in n.inputs],
            }
            if n.attrs:
                entry["attr"] = dict(n.attrs)
            if n.params is not None:
                entry["param"] = n.params.to_dict()
            out_nodes.append(entry)
        graph = {
            "nodes": out_nodes,
            "arg_nodes": [i for i, n in enumerate(nodes) if n.is_variable],
            "heads": [[node_ids[id(n)], idx] for n, idx in self._heads],
            "attrs": {"mxnet_tpu_version": 1},
        }
        return json.dumps(graph, indent=2)

    def save(self, fname: str):
        with open(fname, "w") as f:
            f.write(self.tojson())

    # -- binding (executor factory; implemented in executor.py) -------------
    def bind(self, ctx, args, args_grad=None, grad_req="write", aux_states=None,
             group2ctx=None, shared_exec=None):
        """Bind to caller-provided arrays (reference symbol.py:724).

        ``shared_exec`` is accepted for API compatibility and has no
        effect: ``bind``'s arrays are the caller's, so pass the same
        NDArray objects to both executors to share parameters, or use
        ``simple_bind(..., shared_exec=...)``, which does that."""
        from .executor import Executor

        return Executor._bind(self, ctx, args, args_grad, grad_req, aux_states,
                              group2ctx=group2ctx, shared_exec=shared_exec)

    def simple_bind(self, ctx, grad_req="write", type_dict=None, group2ctx=None,
                    shared_exec=None, **kwargs):
        """Infer shapes, allocate arrays, bind (reference symbol.py:643).

        With ``shared_exec``, parameter/gradient/aux arrays whose name,
        shape, dtype and context match the shared executor's are REUSED
        (the same NDArray objects — updates are visible to both); inputs
        named in ``kwargs`` are always freshly allocated."""
        from .executor import Executor

        return Executor._simple_bind(self, ctx, grad_req, type_dict, group2ctx,
                                     shared_exec, **kwargs)

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other):
        return _sym_ufunc(self, other, "_plus", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, other):
        return _sym_ufunc(self, other, "_minus", "_minus_scalar")

    def __rsub__(self, other):
        return _sym_ufunc(self, other, None, "_rminus_scalar")

    def __mul__(self, other):
        return _sym_ufunc(self, other, "_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return _sym_ufunc(self, other, "_div", "_div_scalar")

    def __rtruediv__(self, other):
        return _sym_ufunc(self, other, None, "_rdiv_scalar")

    def __pow__(self, other):
        return _sym_ufunc(self, other, "_power", "_power_scalar")

    def __neg__(self):
        return _create("negative", [self], {})

    def __repr__(self):
        name = self.name
        return f"<Symbol {name}>" if name else f"<Symbol group of {len(self)}>"

    def __copy__(self):
        return Symbol(list(self._heads))

    def debug_str(self):
        lines = []
        for n in self._topo():
            kind = "Variable" if n.is_variable else n.op.name
            ins = ", ".join(f"{s.name}[{i}]" for s, i in n.inputs)
            lines.append(f"{kind} {n.name}({ins})")
        return "\n".join(lines)


def _sym_ufunc(lhs, rhs, op_name, scalar_op_name):
    if isinstance(rhs, Symbol):
        if op_name is None:
            raise TypeError("operation not supported")
        return _create(op_name, [lhs, rhs], {})
    if isinstance(rhs, (int, float, np.generic)):
        return _create(scalar_op_name, [lhs], {"scalar": float(rhs)})
    raise TypeError(f"unsupported operand type {type(rhs)}")


def _mixed_binary(left, right, op, scalar_op, rscalar_op, py_op, fname):
    """Symbol/Number dispatch of the reference module-level helpers
    (symbol.py:1122-1195 pow/maximum/minimum)."""
    num = numeric_types
    if isinstance(left, Symbol) and isinstance(right, Symbol):
        return _create(op, [left, right], {})
    if isinstance(left, Symbol) and isinstance(right, num):
        return _create(scalar_op, [left], {"scalar": float(right)})
    if isinstance(left, num) and isinstance(right, Symbol):
        return _create(rscalar_op, [right], {"scalar": float(left)})
    if isinstance(left, num) and isinstance(right, num):
        return py_op(left, right)
    raise TypeError(
        f"{fname}: types ({type(left)}, {type(right)}) not supported")


def pow(base, exp):  # noqa: A001 - reference API name
    """base ** exp with Symbol/Number operands (reference symbol.py:1122)."""
    return _mixed_binary(base, exp, "_power", "_power_scalar",
                         "_rpower_scalar", lambda a, b: a ** b, "pow")


def maximum(left, right):
    """Elementwise max with Symbol/Number operands (symbol.py:1148)."""
    # builtins.max explicitly: the registry creator for op "max" shadows
    # the builtin in this module's namespace after _init_symbol_module
    return _mixed_binary(left, right, "_maximum", "_maximum_scalar",
                         "_maximum_scalar", builtins.max, "maximum")


def minimum(left, right):
    """Elementwise min with Symbol/Number operands (symbol.py:1174)."""
    return _mixed_binary(left, right, "_minimum", "_minimum_scalar",
                         "_minimum_scalar", builtins.min, "minimum")


def _infer_graph(topo, known, what, partial):
    """Forward inference over the graph; two passes so late-discovered
    variable values (e.g. FC weight shapes) propagate."""
    import ast as _ast

    values = {}  # ("var", name) | ("out", node_id, idx) -> value
    for n in topo:
        if n.is_variable:
            v = known.get(n.name)
            if v is None and what == "shape" and "__shape__" in n.attrs:
                v = tuple(_ast.literal_eval(n.attrs["__shape__"]))
            values["var", n.name] = v
    for _ in range(2):
        progress = False
        for node in topo:
            if node.is_variable:
                values["out", id(node), 0] = values["var", node.name]
                continue
            n_args = len(node.op.list_arguments(node.params))
            in_vals = []
            for src, idx in node.inputs[:n_args]:
                v = (values.get(("var", src.name)) if src.is_variable
                     else values.get(("out", id(src), idx)))
                in_vals.append(v)
            try:
                if what == "shape":
                    comp_in, outs, auxs = node.op.infer_shape(node.params, in_vals)
                else:
                    comp_in, outs, auxs = node.op.infer_dtype(node.params, in_vals)
            except (ValueError, MXNetError) as e:
                if partial:
                    for i in range(node.num_outputs()):
                        values.setdefault(("out", id(node), i), None)
                    continue
                if isinstance(e, MXNetError):
                    raise
                raise MXNetError(f"infer_{what} at node {node.name}: {e}") from e
            # aux-state variables trail the argument inputs on the node
            for (src, idx), v in zip(node.inputs[n_args:], auxs):
                if src.is_variable and v is not None and values.get(("var", src.name)) is None:
                    values["var", src.name] = tuple(v) if what == "shape" else v
                    progress = True  # aux var nodes need a second pass
            # write back completed input values to variable sources
            for (src, idx), v in zip(node.inputs[:n_args], comp_in):
                if src.is_variable and v is not None:
                    prev = values.get(("var", src.name))
                    if prev is None:
                        values["var", src.name] = tuple(v) if what == "shape" else v
                        progress = True
                    elif what == "shape" and tuple(prev) != tuple(v):
                        raise MXNetError(
                            f"inferred shape conflict for {src.name}: {prev} vs {v}")
            for i, v in enumerate(outs):
                values["out", id(node), i] = v
        if not progress:
            break
    missing = [k for k, v in values.items() if v is None]
    if missing and not partial:
        names = [k[1] for k in missing if k[0] == "var"]
        raise MXNetError(f"infer_{what}: insufficient information for {names}")
    return values


# -- constructors ------------------------------------------------------------
def Variable(name, attr=None, shape=None, **kwargs) -> Symbol:
    """Create a variable symbol (python/mxnet/symbol.py Variable)."""
    attrs = AttrScope.current_attrs()
    if attr:
        attrs.update({k: str(v) for k, v in attr.items()})
    for k, v in kwargs.items():
        attrs["__" + k + "__"] = str(v)
    if shape is not None:
        attrs["__shape__"] = str(tuple(shape))
    return Symbol([(Node(None, name, attrs), 0)])


def Group(symbols) -> Symbol:
    heads = []
    for s in symbols:
        heads.extend(s._heads)
    return Symbol(heads)


def load_json(json_str: str) -> Symbol:
    graph = json.loads(json_str)
    nodes = []
    for entry in graph["nodes"]:
        if entry["op"] == "null":
            node = Node(None, entry["name"], entry.get("attr"))
        else:
            op = OP_REGISTRY.get(entry["op"])
            params = op.make_params(entry.get("param", {}))
            node = Node(op, entry["name"], entry.get("attr"), params,
                        [(nodes[i], idx) for i, idx, *_ in entry["inputs"]])
        nodes.append(node)
    return Symbol([(nodes[i], idx) for i, idx in graph["heads"]])


def load(fname: str) -> Symbol:
    with open(fname) as f:
        return load_json(f.read())


# -- op symbol creation ------------------------------------------------------
def _create(op_name, sym_inputs, kwargs):
    """Create an op node; auto-create variables for unbound args and aux
    states (reference symbol.cc CreateFromAtomicSymbol + Compose)."""
    op = OP_REGISTRY.get(op_name)
    name = kwargs.pop("name", None)
    attr = kwargs.pop("attr", None)
    # split kwargs into symbol inputs vs op params
    sym_kwargs = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
    param_kwargs = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
    # var-arg ops (Concat/ElementWiseSum/Crop) get num_args from the
    # positional count when not given — the reference key_var_num_args
    # auto-fill (python/mxnet/symbol.py:1056-1058), opt-in per op
    kv = op.key_var_num_args
    if kv and kv not in param_kwargs and sym_inputs:
        param_kwargs[kv] = len(sym_inputs)
    params = op.make_params(param_kwargs)
    arg_names = op.list_arguments(params)
    if name is None:
        name = NameManager.get().next_name(op.name.lower())
    attrs = AttrScope.current_attrs()
    if attr:
        attrs.update({k: str(v) for k, v in attr.items()})

    bound = {}
    if sym_inputs:
        if len(sym_inputs) > len(arg_names):
            raise MXNetError(f"{op_name}: too many inputs ({len(sym_inputs)} > "
                             f"{len(arg_names)})")
        for argname, sym in zip(arg_names, sym_inputs):
            bound[argname] = sym
    for k, v in sym_kwargs.items():
        if k not in arg_names:
            raise MXNetError(f"{op_name}: unknown input {k!r}; inputs: {arg_names}")
        if k in bound:
            raise MXNetError(f"{op_name}: input {k!r} bound twice")
        bound[k] = v

    inputs = []
    for argname in arg_names:
        if argname in bound:
            inputs.append(bound[argname]._heads[0])
        else:
            var = Node(None, f"{name}_{argname}", AttrScope.current_attrs())
            inputs.append((var, 0))
    node = Node(op, name, attrs, params, inputs)
    # auxiliary-state variables hang off the node for discovery
    for aux_name in op.list_auxiliary_states(params):
        var = Node(None, f"{name}_{aux_name}", {"__aux__": "1"})
        node.inputs.append((var, 0))
    return Symbol([(node, i) for i in range(op.num_outputs(params))])


def _make_symbol_function(op_name):
    op = OP_REGISTRY.get(op_name)

    def creator(*args, **kwargs):
        sym_inputs = []
        for a in args:
            if not isinstance(a, Symbol):
                raise TypeError(f"{op_name}: positional args must be Symbols")
            sym_inputs.append(a)
        return _create(op_name, sym_inputs, kwargs)

    creator.__name__ = op_name
    creator.__qualname__ = op_name
    creator.__doc__ = (
        f"Symbolic op ``{op_name}``"
        + (f"\n{op.param_cls.__doc__}" if op.param_cls else "")
    )
    return creator


def Custom(*args, op_type=None, **kwargs):
    """Generic custom-op invoker (``mt.sym.Custom(..., op_type=name)``):
    dispatches to the CustomOpProp registered under ``op_type``
    (``operator.register``)."""
    if op_type is None:
        raise TypeError("Custom requires op_type=<registered custom op name>")
    if op_type not in OP_REGISTRY:
        raise MXNetError(f"Custom op {op_type!r} is not registered")
    return _make_symbol_function(op_type)(*args, **kwargs)


def _init_symbol_module():
    mod = sys.modules[__name__]
    # the Symbol/Number dispatch helpers (reference symbol.py:1122-1195)
    # take precedence over raw registry creators of the same name
    keep = {"pow": pow, "maximum": maximum, "minimum": minimum}
    for name in OP_REGISTRY.list():
        fn = _make_symbol_function(name)
        setattr(mod, name, fn)
        canonical = OP_REGISTRY.get(name)
        if canonical.name.lower() == name:
            setattr(mod, canonical.name, fn)
    for name, fn in keep.items():
        setattr(mod, name, fn)


_init_symbol_module()
