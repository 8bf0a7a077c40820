"""Bucketed sequence data iterators for language modeling: the port of
``mxnet_tpu/rnn_io.py`` (MXNet's example/rnn/bucket_io.py:
``BucketSentenceIter`` and the vocabulary helpers).

Variable-length sentences are grouped into a few padded lengths, one
executor a bucket with shared weights (``mod.BucketingModule``).  The
same sentences, batch size, buckets and seed give the reference's
batches, bit for bit, in its order: the iterator draws from its own
``numpy.random.RandomState(seed)`` exactly as the reference's does.
Batches are NDArrays on the current context.
"""

from __future__ import annotations

import numpy as np

from . import ndarray as nd
from .base import MXNetError
from .io import DataBatch, DataDesc, DataIter

__all__ = ["BucketSentenceIter", "build_vocab", "encode_sentences"]


def build_vocab(sentences, start_label=1, invalid_label=0):
    """token -> id map over tokenized sentences (bucket_io
    default_build_vocab); id 0 is reserved for padding/invalid."""
    vocab = {}
    nxt = start_label
    for sent in sentences:
        for tok in sent:
            if tok not in vocab:
                vocab[tok] = nxt
                nxt += 1
    return vocab


def encode_sentences(sentences, vocab):
    return [[vocab[tok] for tok in sent] for sent in sentences]


class BucketSentenceIter(DataIter):
    """Bucketed, padded sentence iterator (bucket_io.BucketSentenceIter).

    Parameters
    ----------
    sentences : list of list of int
        Encoded sentences (see ``encode_sentences``).
    batch_size : int
    buckets : list of int, optional
        Bucket lengths; default = auto from the length histogram
        (lengths that hold >= 1 batch, like the reference's
        default_gen_buckets).
    invalid_label : int
        Padding id (default 0).
    data_name, label_name : str
        Labels are the input shifted one step left (next-token target),
        the reference LM convention.
    init_states : list of (name, shape), optional
        Extra zero-filled state inputs appended to provide_data
        (explicit-unroll LSTM state feeds, bucket_io usage in
        example/rnn/lstm_bucketing.py).
    """

    def __init__(self, sentences, batch_size, buckets=None, invalid_label=0,
                 data_name="data", label_name="softmax_label",
                 init_states=None, shuffle=True, seed=0):
        super().__init__()
        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.invalid_label = invalid_label
        self.init_states = list(init_states or [])
        self._rng = np.random.RandomState(seed)
        self._shuffle = shuffle

        lengths = [len(s) for s in sentences if len(s) > 0]
        if not lengths:
            raise MXNetError("no non-empty sentences")
        if buckets is None:
            hist = np.bincount(lengths)
            buckets = [i for i, n in enumerate(np.cumsum(hist[::-1])[::-1])
                       if i > 0 and n >= batch_size and hist[i] > 0]
            if not buckets:
                buckets = [max(lengths)]
        self.buckets = sorted(buckets)

        self._data = [[] for _ in self.buckets]
        n_dropped = 0
        for sent in sentences:
            if not sent:
                continue
            for i, bkt in enumerate(self.buckets):
                if len(sent) <= bkt:
                    row = np.full(bkt, invalid_label, np.int32)
                    row[:len(sent)] = sent
                    self._data[i].append(row)
                    break
            else:
                n_dropped += 1
        if n_dropped:
            import logging

            logging.warning("BucketSentenceIter: dropped %d sentences longer "
                            "than the largest bucket (%d)", n_dropped,
                            self.buckets[-1])
        self._data = [np.asarray(rows, np.int32) if rows else
                      np.zeros((0, bkt), np.int32)
                      for rows, bkt in zip(self._data, self.buckets)]
        self.default_bucket_key = self.buckets[-1]
        self.reset()

    @property
    def provide_data(self):
        descs = [DataDesc(self.data_name,
                          (self.batch_size, self.default_bucket_key))]
        descs += [DataDesc(n, s) for n, s in self.init_states]
        return descs

    @property
    def provide_label(self):
        return [DataDesc(self.label_name,
                         (self.batch_size, self.default_bucket_key))]

    def reset(self):
        self._plan = []
        for i, rows in enumerate(self._data):
            idx = np.arange(len(rows))
            if self._shuffle:
                self._rng.shuffle(idx)
            for start in range(0, len(rows) - self.batch_size + 1,
                              self.batch_size):
                self._plan.append((i, idx[start:start + self.batch_size]))
        if self._shuffle:
            self._rng.shuffle(self._plan)
        self._cursor = 0

    def next(self) -> DataBatch:
        if self._cursor >= len(self._plan):
            raise StopIteration
        bkt_i, idx = self._plan[self._cursor]
        self._cursor += 1
        bkt = self.buckets[bkt_i]
        data = self._data[bkt_i][idx]
        # next-token labels: shift left, pad tail with invalid_label
        label = np.full_like(data, self.invalid_label)
        label[:, :-1] = data[:, 1:]
        provide_data = [DataDesc(self.data_name, data.shape)]
        batch_data = [nd.array(data)]
        for name, shape in self.init_states:
            provide_data.append(DataDesc(name, shape))
            batch_data.append(nd.zeros(shape))
        return DataBatch(
            batch_data, [nd.array(label)],
            bucket_key=bkt,
            provide_data=provide_data,
            provide_label=[DataDesc(self.label_name, label.shape)])
