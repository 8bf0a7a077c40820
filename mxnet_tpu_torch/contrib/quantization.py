"""Post-training int8 quantization over ``ops/quantized.py``.

The port of ``mxnet_tpu/contrib/quantization.py``: the same rewrite of
the Symbol's JSON, byte for byte, and the same weights and scales.  The
calibration binds the float graph on the current default context (the
card, ``gpu(0)``, or the CPU inside ``with mt.cpu():``), where the
reference binds on its CPU.

``quantize_model`` rewrites a trained symbol so every eligible
FullyConnected / Convolution runs its quantized twin:

- always: per-output-channel symmetric int8 weights (+ f32 scale
  vector) — 4x smaller weight memory/bandwidth, activation-dtype math.
- with ``calib_data``: per-layer activation ranges are observed on
  real batches and baked in as ``act_scale``, so the contraction
  itself runs int8 x int8 -> int32, exactly.

Usage::

    qsym, qargs, qaux = quantize_model(sym, arg_params, aux_params,
                                       calib_data=iter_or_batches)
    exe = qsym.simple_bind(mt.gpu(0), grad_req="null", data=(N, ...))

Non-eligible layers (grouped/dilated convs) and names in ``exclude=``
pass through unchanged.  The first conv is a common exclusion (image
inputs have quantization-hostile statistics): ``exclude=('conv0',)``.
"""

from __future__ import annotations

import ast
import json

import numpy as np

from .. import ndarray as nd
from .. import symbol as sym_mod
from ..base import MXNetError
from ..context import current_context

__all__ = ["quantize_model", "quantize_weight"]

_QUANTIZABLE = {"FullyConnected": "QuantizedFullyConnected",
                "Convolution": "QuantizedConvolution"}
# params the quantized conv twin does not carry: backend knobs get
# dropped silently; structural options make the layer ineligible
_CONV_DROP = ("workspace", "cudnn_tune", "cudnn_off", "num_group",
              "dilate")


def quantize_weight(w):
    """Per-output-channel symmetric int8: returns (int8 array, f32
    scales) with w ≈ wq * scale[:, None, ...]."""
    w = np.asarray(w, np.float32)
    flat = w.reshape(w.shape[0], -1)
    amax = np.max(np.abs(flat), axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    wq = np.clip(np.round(flat / scale[:, None]), -127, 127).astype(np.int8)
    return wq.reshape(w.shape), scale


def _parse_params(node):
    out = {}
    for k, v in node.get("param", {}).items():
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def _eligible(node, exclude):
    if node["op"] not in _QUANTIZABLE or node["name"] in exclude:
        return False
    if node["op"] == "Convolution":
        p = _parse_params(node)
        if p.get("num_group", 1) not in (1,):
            return False
        d = p.get("dilate")
        if d and tuple(d) != (1,) * len(tuple(d)):
            return False
    return True


def _calibrate(symbol, arg_params, aux_params, taps, calib_data,
               num_batches, data_name):
    """Max-abs activation calibration: bind the FLOAT net's internals so
    each target layer's INPUT activation is observed on real batches;
    ``taps`` maps layer name -> POSITIONAL internal-output index.
    Returns {layer_name: act_scale}."""
    internals = symbol.get_internals()
    names = list(taps)
    group = sym_mod.Group([internals[int(taps[n])] for n in names])

    amax = {n: 0.0 for n in names}
    exes = {}  # batch shape -> bound executor (ragged final batches)
    seen = 0
    for batch in calib_data:
        if seen >= num_batches:
            break
        # DataBatch carries .data as a list; a raw numpy array also has
        # a .data attribute (its memoryview), so duck-type carefully
        data = (batch.data[0]
                if isinstance(getattr(batch, "data", None), (list, tuple))
                else batch)
        arr = data.asnumpy() if isinstance(data, nd.NDArray) \
            else np.asarray(data, np.float32)
        exe = exes.get(arr.shape)
        if exe is None:
            exe = group.simple_bind(current_context(), grad_req="null",
                                    **{data_name: arr.shape})
            for k, v in arg_params.items():
                if k in exe.arg_dict and k != data_name:
                    exe.arg_dict[k][:] = v
            for k, v in (aux_params or {}).items():
                if k in exe.aux_dict:
                    exe.aux_dict[k][:] = v
            exes[arr.shape] = exe
        exe.arg_dict[data_name][:] = arr
        outs = exe.forward(is_train=False)
        for n, out in zip(names, outs):
            amax[n] = max(amax[n], float(np.max(np.abs(out.asnumpy()))))
        seen += 1
    if seen == 0:
        raise MXNetError("quantize_model: calib_data yielded no batches")
    return {n: (a / 127.0 if a > 0 else 1.0) for n, a in amax.items()}


def _internal_offsets(nodes):
    """``(offsets, total)``: each node's first POSITIONAL index among the
    symbol's ``get_internals()`` outputs, and their count.  Indexing
    internals by position — tojson emits nodes in the same topo order
    get_internals walks, one entry per op output — avoids name
    collisions (e.g. an RNN's 'rnn_state' output vs its 'rnn_state'
    initial-state variable)."""
    from ..ops import OP_REGISTRY

    offsets, total = [], 0
    for node in nodes:
        offsets.append(total)
        if node["op"] == "null":
            total += 1
        else:
            op = OP_REGISTRY.get(node["op"])
            total += op.num_outputs(op.make_params(node.get("param", {})))
    return offsets, total


def quantize_model(symbol, arg_params, aux_params=None, calib_data=None,
                   num_calib_batches=5, exclude=(), data_name="data"):
    """Rewrite ``symbol`` + params for int8 inference.

    Returns ``(qsym, qarg_params, qaux_params)``.  With ``calib_data``
    (a DataIter or iterable of array batches) the quantized layers also
    carry calibrated activation scales (full-int8 contractions);
    without it they run the weight-only dequant path.
    """
    if isinstance(exclude, str):
        exclude = (exclude,)  # a bare string must not degrade to chars
    exclude = set(exclude)
    conf = json.loads(symbol.tojson())
    nodes = conf["nodes"]

    # layer -> POSITIONAL index of the internal output feeding its data
    # input (the calibration tap; see _internal_offsets).  Resolution
    # only happens — and can only raise — on the calibrated path.
    targets = [node for node in nodes
               if _eligible(node, exclude)
               and node["name"] + "_weight" in arg_params]
    taps = {}
    if calib_data is not None:
        offsets, total = _internal_offsets(nodes)
        n_internal = len(symbol.get_internals().list_outputs())
        if total != n_internal:
            raise MXNetError(
                f"quantize_model: internal-output count mismatch "
                f"({total} vs {n_internal})")
        for node in targets:
            src_idx, out_idx = node["inputs"][0][0], node["inputs"][0][1]
            taps[node["name"]] = offsets[src_idx] + out_idx

    act_scales = {}
    if calib_data is not None and taps:
        act_scales = _calibrate(symbol, arg_params, aux_params, taps,
                                calib_data, num_calib_batches, data_name)

    qargs = {k: (v if isinstance(v, nd.NDArray) else nd.array(v))
             for k, v in arg_params.items()}
    # rebuild the node list in topological order: each quantized layer's
    # wscale variable must appear BEFORE its consumer, so indices shift
    # and every reference is remapped through old -> new
    target_names = {node["name"] for node in targets}
    new_nodes = []
    remap = {}
    for old_idx, node in enumerate(nodes):
        name = node["name"]
        if name in target_names:
            w = qargs.pop(name + "_weight")
            wq, scale = quantize_weight(w.asnumpy())
            qargs[name + "_weight"] = nd.array(wq, dtype=np.int8)
            qargs[name + "_wscale"] = nd.array(scale)
            new_nodes.append({"op": "null", "name": name + "_wscale",
                              "inputs": []})
            scale_idx = len(new_nodes) - 1

            node = dict(node)
            node["op"] = _QUANTIZABLE[node["op"]]
            param = {k: v for k, v in node.get("param", {}).items()
                     if k not in _CONV_DROP}
            if name in act_scales:
                param["act_scale"] = repr(act_scales[name])
            node["param"] = param
            inputs = [[remap[i], oi] + rest
                      for i, oi, *rest in node["inputs"]]
            node["inputs"] = (inputs[:2] + [[scale_idx, 0]] + inputs[2:])
        else:
            node = dict(node)
            node["inputs"] = [[remap[i], oi] + rest
                              for i, oi, *rest in node["inputs"]]
        new_nodes.append(node)
        remap[old_idx] = len(new_nodes) - 1

    conf["nodes"] = new_nodes
    conf["heads"] = [[remap[i], oi] + rest
                     for i, oi, *rest in conf.get("heads", [])]
    conf["arg_nodes"] = [i for i, n in enumerate(new_nodes)
                         if n["op"] == "null"]
    qsym = sym_mod.load_json(json.dumps(conf))
    return qsym, qargs, dict(aux_params or {})
