"""Data iterators, the training core: the port of ``mxnet_tpu/io.py``'s
``DataDesc``, ``DataBatch``, ``DataIter`` and ``NDArrayIter``.  Batches
are NDArrays on the current context; ``NDArrayIter(shuffle=True)``
permutes with :func:`mxnet_tpu_torch.random.np_rng`.  The rest of the
reference's ``io`` (record, CSV, MNIST and prefetching iterators) is
ROADMAP §A17.
"""

from __future__ import annotations

import numpy as np

from . import ndarray as nd
from . import random as _random
from . import telemetry
from .base import MXNetError
from .ndarray import NDArray

__all__ = ["DataIter", "DataBatch", "NDArrayIter", "DataDesc"]


class DataDesc:
    """Name+shape(+dtype+layout) of one data stream (io.py DataDesc)."""

    def __init__(self, name, shape, dtype=np.float32, layout="NCHW"):
        self.name = name
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layout = layout

    def __iter__(self):  # unpack like a (name, shape) tuple
        yield self.name
        yield self.shape

    def __getitem__(self, i):
        return (self.name, self.shape)[i]

    def __repr__(self):
        return f"DataDesc[{self.name},{self.shape},{self.dtype},{self.layout}]"

    @staticmethod
    def get_batch_axis(layout):
        """Batch ('N') axis of a layout string; 0 for None (whole-array
        default), -1 when the layout has no batch axis (reference io.py
        DataDesc.get_batch_axis — the one implementation; the executor
        group's slicing delegates here)."""
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        """DataDesc list from (name, shape) pairs and optional
        (name, type) pairs (reference io.py:629-643)."""
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference io.py:86)."""

    def __init__(self, data, label=None, pad=0, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label if label is not None else []
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


def _tel_batch_counter(it):
    """Per-instance cached ``mxtpu_io_batches_total{iterator=...}``
    child (the shared NOOP when telemetry is disabled, so the counting
    costs one attribute call per batch)."""
    child = getattr(it, "_tel_batches", None)
    if child is None:
        child = telemetry.counter(
            "mxtpu_io_batches_total", "batches produced by data iterators",
            ("iterator",)).labels(iterator=type(it).__name__)
        it._tel_batches = child
    return child


class DataIter:
    """Iterator protocol (reference io.py:100): reset / next / iter, with
    provide_data/provide_label shape advertisement."""

    def __init__(self):
        self.batch_size = 0

    def reset(self):
        pass

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()

    def next(self) -> DataBatch:
        if self.iter_next():
            _tel_batch_counter(self).inc()
            return DataBatch(self.getdata(), self.getlabel(), self.getpad(),
                             self.getindex())
        raise StopIteration

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        return None

    def getlabel(self):
        # base returns None (reference io.py:152-160 `pass`): label-free
        # iterators (e.g. a GAN noise source) only override getdata
        return None

    def getindex(self):
        return None

    def getpad(self):
        return 0

    # NOTE: not properties — the reference idiom lets subclasses simply
    # assign self.provide_data/provide_label in __init__ (e.g. the
    # reference DCGAN's RandIter, example/gan/dcgan.py:75-80); read-only
    # properties here would break such user iterators.
    provide_data = None
    provide_label = None


def _init_data(data, allow_empty, default_name):
    """Normalize input data to list of (name, np.ndarray) (io.py:330-365)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data cannot be None")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if not allow_empty and len(data) == 0:
            raise ValueError("empty data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("data must be array, list or dict")
    out = []
    for k, v in data.items():
        if isinstance(v, NDArray):
            v = v.asnumpy()
        out.append((k, np.asarray(v)))
    return out


class NDArrayIter(DataIter):
    """Iterate over in-memory numpy/NDArray data (reference io.py:402).

    Supports shuffle, discard/pad/roll_over last-batch handling.
    """

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data", label_name="softmax_label"):
        super().__init__()
        self.data = _init_data(data, allow_empty=False, default_name=data_name)
        self.label = _init_data(label, allow_empty=True, default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if shuffle:
            perm = _random.np_rng().permutation(self.num_data)
            self.data = [(k, v[perm]) for k, v in self.data]
            self.label = [(k, v[perm]) for k, v in self.label]
        if last_batch_handle == "discard":
            self.num_data = (self.num_data // batch_size) * batch_size
        if self.num_data < batch_size:
            raise MXNetError("batch_size larger than dataset size")
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle
        self.cursor = -batch_size

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        """Ignore roll_over: rewind to the exact start (reference
        io.py:477)."""
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, data_source):
        if self.cursor + self.batch_size <= self.num_data:
            return [nd.array(v[self.cursor:self.cursor + self.batch_size])
                    for _, v in data_source]
        # pad: wrap around
        pad = self.batch_size - (self.num_data - self.cursor)
        return [nd.array(np.concatenate([v[self.cursor:], v[:pad]], axis=0))
                for _, v in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if (self.last_batch_handle == "pad"
                and self.cursor + self.batch_size > self.num_data):
            return self.cursor + self.batch_size - self.num_data
        return 0
