"""Graph executor: the port of ``mxnet_tpu/executor.py``.

The executor walks the Symbol's graph in topological order on torch
tensors.  A training forward runs under autograd, with each argument
whose gradient is requested as a leaf; ``backward`` consumes that graph
with ``torch.autograd.grad`` (head gradients of ones when none are
given; loss ops ignore them) and commits the gradients to the bound
arrays by ``grad_req`` (``write``, ``add`` or ``null``).  The reference
instead traces forward and backward into one program and re-runs it for
explicit head gradients; the gradients are the same.  A backward that
finds the graph consumed (a second backward with explicit head
gradients) re-runs the forward with the same random key first, so
random ops reproduce the activations the caller saw.

Ops with an explicit backward (loss layers, BlockGrad) run through a
``torch.autograd.Function`` (``ops.op.apply_op``).  Mirroring
(``force_mirroring`` attrs, ``MXNET_BACKWARD_DO_MIRROR``) recomputes in
backward through ``torch.utils.checkpoint`` (``use_reentrant=False``):
per node, or per block of consecutive nodes sharing a ``mirror_stage``.
Random ops draw from a key derived from the executor's own chain, which
:func:`mxnet_tpu_torch.random.seed` seeds.

A graph whose nodes land on one context runs as one segment; distinct
contexts (``group2ctx`` over several devices) raise, naming ROADMAP
§A18.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import ndarray as nd
from . import random as _random
from .base import MXNetError, dtype_name
from .graph import assign_contexts, one_context
from .ndarray import NDArray
from .ops.op import RngKey, apply_op

__all__ = ["Executor"]


def _sub_keys(key, n):
    """``n`` keys derived from ``key`` (the per-node keys of one
    evaluation)."""
    if not n:
        return None
    gen = torch.Generator().manual_seed(int(key.seed))
    seeds = torch.randint(0, 2 ** 62, (n,), generator=gen).tolist()
    return [RngKey(s, key.device) for s in seeds]


class _GraphRunner:
    """Evaluator of a Symbol's node graph on one device."""

    def __init__(self, symbol):
        self.symbol = symbol
        self.topo = symbol._topo()
        # global gradient-checkpointing switch (reference
        # MXNET_BACKWARD_DO_MIRROR); per-node force_mirroring attrs still
        # apply when unset
        self._mirror_all = os.environ.get(
            "MXNET_BACKWARD_DO_MIRROR", "0") in ("1", "true", "True")
        self.heads = symbol._heads
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.rng_nodes = [n for n in self.topo
                          if not n.is_variable and n.op.need_rng]
        self._aux_of_node = {}
        for node in self.topo:
            if node.is_variable:
                continue
            n_args = len(node.op.list_arguments(node.params))
            aux_vars = [src.name for src, _ in node.inputs[n_args:]]
            self._aux_of_node[id(node)] = (n_args, aux_vars)
        self._segments = self._build_segments()

    def _node_mirrored(self, node):
        return self._mirror_all or node.attrs.get(
            "force_mirroring", "") in ("1", "true", "True")

    def _build_segments(self):
        """Group maximal contiguous runs of mirrored nodes sharing a
        ``mirror_stage`` into blocks, each recomputed as one checkpoint
        (only the block-boundary activations are kept).  Mirrored nodes
        without a stage checkpoint one by one.

        Returns a list of ('node', node) / ('remat', payload) entries;
        only the train path uses it."""
        segments = [("node", n) for n in self.topo if n.is_variable]
        run = []

        def flush():
            if len(run) > 1:
                segments.append(("remat", list(run)))
            else:
                segments.extend(("node", n) for n in run)
            run.clear()

        prev_stage = None
        for node in self.topo:
            if node.is_variable:
                continue
            stage = node.attrs.get("mirror_stage")
            if self._node_mirrored(node) and stage is not None:
                if run and stage != prev_stage:
                    flush()
                prev_stage = stage
                run.append(node)
            else:
                flush()
                prev_stage = None
                segments.append(("node", node))
        flush()

        # consumers outside each block + heads define the block outputs
        consumed = {}
        for node in self.topo:
            if node.is_variable:
                continue
            n_args, _ = self._aux_of_node[id(node)]
            for src, idx in node.inputs[:n_args]:
                consumed.setdefault((id(src), idx), set()).add(id(node))
        head_keys = {(id(n), i) for n, i in self.heads}

        out = []
        for kind, payload in segments:
            if kind != "remat":
                out.append((kind, payload))
                continue
            nodes = payload
            block_ids = {id(n) for n in nodes}
            ext_keys, seen = [], set()
            aux_in, aux_seen = [], set()
            for n in nodes:
                n_args, aux_names = self._aux_of_node[id(n)]
                for src, idx in n.inputs[:n_args]:
                    k = (id(src), idx)
                    if id(src) not in block_ids and k not in seen:
                        seen.add(k)
                        ext_keys.append(k)
                for a in aux_names:
                    if a not in aux_seen:
                        aux_seen.add(a)
                        aux_in.append(a)
            out_keys = []
            for n in nodes:
                for i in range(n.num_outputs()):
                    k = (id(n), i)
                    users = consumed.get(k, set())
                    if k in head_keys or users - block_ids:
                        out_keys.append(k)
            out.append(("remat", (nodes, ext_keys, aux_in, out_keys)))
        return out

    def _run_node(self, node, env, new_aux, subkeys, rng_idx, train,
                  collect, use_checkpoint=False):
        """Evaluate one node from/into env + new_aux."""
        n_args, aux_names = self._aux_of_node[id(node)]
        ins = [env[id(src), idx] for src, idx in node.inputs[:n_args]]
        auxs = [new_aux[a] for a in aux_names]
        nkey = subkeys[rng_idx[id(node)]] if id(node) in rng_idx else None
        if use_checkpoint and torch.is_grad_enabled():
            def body(*i, _n=node, _k=nkey, _a=auxs):
                outs, aux_out = apply_op(_n.op, _n.params, list(i), list(_a),
                                         train, _k)
                return tuple(outs) + tuple(aux_out)

            res = checkpoint(body, *ins, use_reentrant=False)
            n_out = node.num_outputs()
            outs, node_new_aux = list(res[:n_out]), list(res[n_out:])
        else:
            outs, node_new_aux = apply_op(node.op, node.params, ins, auxs,
                                          train, nkey)
        for a, v in zip(aux_names, node_new_aux):
            new_aux[a] = v
        for i, o in enumerate(outs):
            env[id(node), i] = o
            if collect is not None:
                out_name = (f"{node.name}_"
                            f"{node.op.list_outputs(node.params)[i]}")
                collect.append((out_name, o))

    def rng_state(self, key):
        """(subkeys, rng_idx) for one evaluation: the one key-splitting
        scheme of the full and the stepwise (``partial_forward``)
        paths, so a stepwise run reproduces a full run's randomness."""
        subkeys = _sub_keys(key, len(self.rng_nodes))
        rng_idx = {id(n): i for i, n in enumerate(self.rng_nodes)}
        return subkeys, rng_idx

    def place_vars(self, env, arg_vals, aux_vals):
        for node in self.topo:
            if not node.is_variable:
                continue
            if node.name in arg_vals:
                env[id(node), 0] = arg_vals[node.name]
            elif node.name in aux_vals:
                env[id(node), 0] = aux_vals[node.name]

    def __call__(self, arg_vals: dict, aux_vals: dict, key, train: bool,
                 collect=None):
        """Evaluate the graph.  Returns (outputs tuple, new_aux dict)."""
        env = {}
        subkeys, rng_idx = self.rng_state(key)
        new_aux = dict(aux_vals)
        self.place_vars(env, arg_vals, aux_vals)
        # block-level recomputation applies on the train path only (the
        # backward is what keeps activations); monitored runs need every
        # output, so they take the per-node path
        if not (train and collect is None):
            for node in self.topo:
                if not node.is_variable:
                    self._run_node(node, env, new_aux, subkeys, rng_idx,
                                   train, collect,
                                   use_checkpoint=train
                                   and self._node_mirrored(node))
            return tuple(env[id(n), i] for n, i in self.heads), new_aux

        for kind, payload in self._segments:
            if kind == "node":
                node = payload
                if not node.is_variable:
                    self._run_node(node, env, new_aux, subkeys, rng_idx,
                                   train, None,
                                   use_checkpoint=self._node_mirrored(node))
                continue
            nodes, ext_keys, aux_in, out_keys = payload

            def seg_fn(*vals, _nodes=nodes, _ext=ext_keys, _aux=aux_in,
                       _out=out_keys):
                local_env = dict(zip(_ext, vals[:len(_ext)]))
                local_aux = dict(zip(_aux, vals[len(_ext):]))
                for n in _nodes:
                    self._run_node(n, local_env, local_aux, subkeys,
                                   rng_idx, train, None)
                return (tuple(local_env[k] for k in _out)
                        + tuple(local_aux[a] for a in _aux))

            vals = [env[k] for k in ext_keys] + [new_aux[a] for a in aux_in]
            if torch.is_grad_enabled():
                res = checkpoint(seg_fn, *vals, use_reentrant=False)
            else:
                res = seg_fn(*vals)
            for k, v in zip(out_keys, res[:len(out_keys)]):
                env[k] = v
            for a, v in zip(aux_in, res[len(out_keys):]):
                new_aux[a] = v
        return tuple(env[id(n), i] for n, i in self.heads), new_aux


class Executor:
    """Bound computation over one context (reference
    python/mxnet/executor.py)."""

    def __init__(self, symbol, ctx, grad_req, arg_arrays, grad_arrays, aux_arrays,
                 group2ctx=None):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.output_names = symbol.list_outputs()
        self.arg_arrays = arg_arrays
        self.grad_arrays = grad_arrays
        self.aux_arrays = aux_arrays
        self.arg_dict = dict(zip(self.arg_names, arg_arrays))
        self.grad_dict = {k: g for k, g in zip(self.arg_names, grad_arrays)
                          if g is not None}
        self.aux_dict = dict(zip(self.aux_names, aux_arrays))
        if isinstance(grad_req, str):
            grad_req = {k: grad_req for k in self.arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(self.arg_names, grad_req))
        self._grad_req = {k: (grad_req.get(k, "null") if grad_arrays else "null")
                          for k in self.arg_names}
        for k, g in zip(self.arg_names, grad_arrays or [None] * len(self.arg_names)):
            if g is None:
                self._grad_req[k] = "null"
        self._grad_names = [k for k in self.arg_names if self._grad_req[k] != "null"]

        # one segment: every node on one context (ROADMAP §A18 otherwise)
        var_ctx = {name: arr.context
                   for name, arr in zip(self.arg_names, arg_arrays)}
        for name, arr in zip(self.aux_names, aux_arrays):
            var_ctx[name] = arr.context
        one_context(assign_contexts(symbol, ctx, group2ctx, var_ctx))
        self._device = ctx.torch_device()

        self._graph = _GraphRunner(symbol)
        self._chain = torch.Generator().manual_seed(_random.next_key().seed)
        self._outputs = None
        self._monitor_callback = None
        # the autograd graph of the last training forward: (head tensors,
        # {name: leaf}); None once backward consumed it
        self._pending = None
        # key of the last training forward (full or stepwise): a backward
        # that must re-run the forward uses it
        self._last_key = None
        self._fwd_nodes = [n for n in self._graph.topo if not n.is_variable]
        self._partial = None

    # -- factory helpers (Symbol.bind / simple_bind) -------------------------
    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states, group2ctx=None,
              shared_exec=None):
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_arrays = Executor._to_list(args, arg_names, "args")
        if args_grad is None:
            grad_arrays = [None] * len(arg_names)
        else:
            grad_arrays = Executor._to_list(args_grad, arg_names, "args_grad",
                                            allow_missing=True)
        aux_arrays = Executor._to_list(aux_states or [], aux_names, "aux_states")
        return Executor(symbol, ctx, grad_req, arg_arrays, grad_arrays, aux_arrays,
                        group2ctx=group2ctx)

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req="write", type_dict=None, group2ctx=None,
                     shared_exec=None, **kwargs):
        arg_shapes, _, aux_shapes = symbol.infer_shape(**kwargs)
        type_dict = type_dict or {}
        arg_types, _, aux_types = symbol.infer_type(**dict(type_dict))
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        def _reuse(pool, name, shape, dtype, c):
            """Sharing with ``shared_exec``: reuse the shared executor's
            NDArray object when name, shape, dtype and context all
            match, so both executors see every update to it.  Inputs
            given shapes in ``kwargs`` (data, labels) are never shared.
            A name the donor holds at another shape, dtype or context
            raises (partial sharing would train that parameter apart)."""
            if pool is None or name in kwargs:
                return None
            arr = pool.get(name)
            if arr is None:
                return None
            want = dtype_name(dtype or np.float32)
            if (tuple(arr.shape) != tuple(shape)
                    or dtype_name(arr.dtype) != want or arr.context != c):
                raise MXNetError(
                    f"shared_exec holds {name!r} with shape "
                    f"{tuple(arr.shape)} dtype {dtype_name(arr.dtype)} on "
                    f"{arr.context}, incompatible with required shape "
                    f"{tuple(shape)} dtype {want} on {c}")
            return arr

        shared_args = shared_exec.arg_dict if shared_exec is not None else None
        shared_grads = shared_exec.grad_dict if shared_exec is not None else None
        shared_aux = shared_exec.aux_dict if shared_exec is not None else None
        # with ctx groups, allocate each variable on its assigned context
        # (and raise, naming §A18, when they span distinct ones)
        name_ctx = {}
        if group2ctx:
            ctx_of = assign_contexts(symbol, ctx, group2ctx)
            one_context(ctx_of)
            for node in symbol._topo():
                if node.is_variable:
                    name_ctx[node.name] = ctx_of[id(node)]
        arg_ctxs = [name_ctx.get(k, ctx) for k in arg_names]
        aux_ctxs = [name_ctx.get(k, ctx) for k in aux_names]

        def _alloc(pool, k, s, t, c):
            arr = _reuse(pool, k, s, t, c)
            if arr is None:
                arr = nd.zeros(s, ctx=c, dtype=t or np.float32)
            return arr

        arg_arrays = [_alloc(shared_args, k, s, t, c)
                      for k, s, t, c in zip(arg_names, arg_shapes, arg_types,
                                            arg_ctxs)]
        aux_arrays = [_alloc(shared_aux, k, s, t, c)
                      for k, s, t, c in zip(aux_names, aux_shapes, aux_types,
                                            aux_ctxs)]
        req = grad_req if isinstance(grad_req, dict) else {
            k: grad_req for k in arg_names}
        grad_arrays = [
            _alloc(shared_grads, k, s, t, c)
            if req.get(k, "null") != "null" else None
            for k, s, t, c in zip(arg_names, arg_shapes, arg_types, arg_ctxs)
        ]
        return Executor(symbol, ctx, req, arg_arrays, grad_arrays, aux_arrays,
                        group2ctx=group2ctx)

    @staticmethod
    def _to_list(values, names, what, allow_missing=False):
        if isinstance(values, dict):
            out = []
            for k in names:
                if k in values:
                    out.append(values[k])
                elif allow_missing:
                    out.append(None)
                else:
                    raise MXNetError(f"{what}: missing entry for {k!r}")
            return out
        values = list(values)
        if len(values) != len(names):
            raise MXNetError(f"{what}: expected {len(names)} entries, got {len(values)}")
        return values

    # -- execution ----------------------------------------------------------
    def _gather(self):
        args = {k: a._data for k, a in zip(self.arg_names, self.arg_arrays)}
        aux = {k: a._data for k, a in zip(self.aux_names, self.aux_arrays)}
        return args, aux

    def _next_key(self):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._chain))
        return RngKey(seed, self._device)

    def _leaves(self, args):
        """Each argument whose gradient is requested as an autograd leaf
        over the bound array's storage."""
        leaves = {}
        for k in self._grad_names:
            t = args[k]
            if t.is_floating_point():
                leaves[k] = t.detach().requires_grad_(True)
        args.update(leaves)
        return leaves

    def _commit_aux(self, new_aux):
        with torch.no_grad():
            for k, arr in zip(self.aux_names, self.aux_arrays):
                v = new_aux[k]
                if v is not arr._data:
                    arr._data.copy_(v.detach())

    def _run(self, key, is_train, collect=None):
        """One full forward with ``key``: outputs, and the autograd
        graph kept pending when gradients are requested."""
        args, aux = self._gather()
        build = bool(is_train and self._grad_names)
        with torch.set_grad_enabled(build):
            leaves = self._leaves(args) if build else {}
            outs, new_aux = self._graph(args, aux, key, is_train,
                                        collect=collect)
        self._pending = (outs, leaves) if build else None
        return outs, new_aux

    def forward(self, is_train=False, **kwargs):
        """Run forward (reference executor.py:84).  kwargs assign input
        arrays by name before running (e.g. ``exe.forward(data=batch)``)."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError(f"unknown input {k!r}")
            self.arg_dict[k][:] = v
        # a fresh forward drops any stepwise run and pending graph first
        self._partial = None
        self._pending = None
        key = self._next_key()
        collect = [] if self._monitor_callback is not None else None
        outs, new_aux = self._run(key, is_train, collect)
        if collect:
            for name, val in collect:
                self._monitor_callback(name, NDArray(val.detach(), self._ctx))
        if is_train:
            self._last_key = key
            self._commit_aux(new_aux)
        self._outputs = [NDArray(o.detach(), self._ctx) for o in outs]
        return self._outputs

    @property
    def num_forward_nodes(self):
        """Number of forward compute nodes = number of partial_forward
        steps."""
        return len(self._fwd_nodes)

    def partial_forward(self, is_train=False, step=0):
        """Run forward node ``step`` only and return the number of steps
        left (reference ``GraphExecutor::PartialForward``): call with
        increasing ``step`` from 0 until 0 is returned.  Each node runs
        alone, firing the monitor callback per output.  After the last
        step ``outputs`` equals a full forward's and, for a training
        run, ``backward()`` works as after ``forward``."""
        if step >= len(self._fwd_nodes):
            return 0
        st = self._partial
        if step == 0:
            self._pending = None
            args, aux = self._gather()
            key = self._next_key()
            build = bool(is_train and self._grad_names)
            with torch.set_grad_enabled(build):
                leaves = self._leaves(args) if build else {}
            env = {}
            self._graph.place_vars(env, args, aux)
            subkeys, rng_idx = self._graph.rng_state(key)
            st = self._partial = {"env": env, "aux": dict(aux),
                                  "subkeys": subkeys, "rng_idx": rng_idx,
                                  "key": key, "next": 0, "leaves": leaves,
                                  "build": build}
        if st is None or step != st["next"]:
            expected = 0 if st is None else st["next"]
            raise MXNetError(
                f"partial_forward step {step}: steps must be executed in "
                f"increasing order from 0 (expected step {expected})")
        node = self._fwd_nodes[step]
        collect = [] if self._monitor_callback is not None else None
        with torch.set_grad_enabled(st["build"]):
            self._graph._run_node(node, st["env"], st["aux"], st["subkeys"],
                                  st["rng_idx"], is_train, collect)
        st["next"] = step + 1
        for name, val in collect or ():
            self._monitor_callback(name, NDArray(val.detach(), self._ctx))
        step_left = len(self._fwd_nodes) - step - 1
        if step_left == 0:
            outs = tuple(st["env"][id(n), i] for n, i in self._graph.heads)
            self._outputs = [NDArray(o.detach(), self._ctx) for o in outs]
            if is_train:
                self._commit_aux(st["aux"])
                self._last_key = st["key"]
            self._pending = (outs, st["leaves"]) if st["build"] else None
            self._partial = None
        return step_left

    def backward(self, out_grads=None):
        """Commit gradients (reference executor.py:123): head gradients
        of ones when ``out_grads`` is None (loss ops ignore them)."""
        if not self._grad_names:
            return
        if self._pending is None:
            if out_grads is None or self._last_key is None:
                raise MXNetError("backward called before forward(is_train=True)")
            # the graph was consumed: re-run the forward with the last
            # key, so random ops reproduce the activations seen
            self._run(self._last_key, True)
        outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            heads = []
            for g, o in zip(out_grads, outs):
                g = g._data if isinstance(g, NDArray) else torch.as_tensor(
                    np.asarray(g))
                heads.append(g.to(device=o.device, dtype=o.dtype))
        names = [k for k in self._grad_names if k in leaves]
        live = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        grads = [None] * len(names)
        if live and names:
            grads = torch.autograd.grad([o for o, _ in live],
                                        [leaves[k] for k in names],
                                        [h for _, h in live],
                                        allow_unused=True)
        grads = dict(zip(names, grads))
        with torch.no_grad():
            for k, garr in zip(self.arg_names, self.grad_arrays):
                if garr is None or self._grad_req[k] == "null":
                    continue
                g = grads.get(k)
                if self._grad_req[k] == "add":
                    if g is not None:
                        garr._data.add_(g)
                elif g is None:
                    garr._data.zero_()
                else:
                    garr._data.copy_(g)

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("run forward() first")
        return self._outputs

    @property
    def output_dict(self):
        """Name -> output NDArray (raises on duplicated output names, as
        the reference does)."""
        outs = self.outputs
        d = {}
        for name, arr in zip(self.output_names, outs):
            if name in d:
                raise MXNetError(
                    f"duplicate output name {name!r}: use `outputs` for "
                    "positional access")
            d[name] = arr
        return d

    # -- misc API -----------------------------------------------------------
    def set_monitor_callback(self, callback):
        """Install a per-output callback ``callback(name, NDArray)``,
        called for every node output of each forward."""
        self._monitor_callback = callback

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for k, v in arg_params.items():
            if k in self.arg_dict:
                self.arg_dict[k][:] = v
            elif not allow_extra_params:
                raise MXNetError(f"unknown arg {k!r}")
        if aux_params:
            for k, v in aux_params.items():
                if k in self.aux_dict:
                    self.aux_dict[k][:] = v
                elif not allow_extra_params:
                    raise MXNetError(f"unknown aux {k!r}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor for new input shapes (reference executor.py
        reshape):

        - an array not named in ``kwargs`` may only change shape when
          ``partial_shaping=True``;
        - an array may only grow when ``allow_up_sizing=True``; a
          same-or-smaller one is a view over the old array's leading
          elements (its memory is reused, as in the reference).
        """
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        ctx = self._ctx

        def remake(name, arr, shp, direct):
            shp = tuple(shp)
            if tuple(arr.shape) == shp:
                return arr
            if not partial_shaping and not direct:
                raise MXNetError(
                    f"cannot reshape array {name!r}: its shape changed as a "
                    "consequence of the requested input shapes; pass "
                    "partial_shaping=True to allow this")
            if np.prod(shp) > np.prod(arr.shape):
                if not allow_up_sizing:
                    raise MXNetError(
                        f"new shape of arg {name!r} is larger than the "
                        "original; set allow_up_sizing=True to allocate a "
                        "bigger array")
                return nd.zeros(shp, ctx=ctx, dtype=arr.dtype)
            flat = arr._data.reshape(-1)[: int(np.prod(shp))]
            return NDArray(flat.reshape(shp), ctx)

        new_args, grad_arrays = [], []
        for name, shp, arr, garr in zip(self.arg_names, arg_shapes,
                                        self.arg_arrays, self.grad_arrays):
            new_args.append(remake(name, arr, shp, name in kwargs))
            grad_arrays.append(None if garr is None
                               else remake(name, garr, shp, name in kwargs))
        new_aux = [remake(name, arr, shp, False)
                   for name, shp, arr in zip(self._symbol.list_auxiliary_states(),
                                             aux_shapes, self.aux_arrays)]
        return Executor(self._symbol, ctx, self._grad_req, new_args, grad_arrays,
                        new_aux)

    def debug_str(self):
        return self._symbol.debug_str()
