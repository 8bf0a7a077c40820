"""The port's BucketingModule, rnn_io and lstm_unroll_symbol against the
JAX reference's, on the CPU.

- An RNN-op language model (Embedding -> SwapAxis -> RNN (2 LSTM layers)
  -> SwapAxis -> Reshape -> FullyConnected -> SoftmaxOutput) under
  ``mod.BucketingModule`` in both packages, from the same numpy
  parameters, through batches of buckets 16, 8, 16, 8 with SGD (momentum
  and weight decay): every parameter after each update within 2e-6 of
  the reference's (float32 products summed in other orders over four
  updates); every bucket's arrays are the default bucket's storage; a
  switch after an update reads the trained values; a second
  BucketingModule bound with ``shared_module=`` shares them and the
  optimizer; ``fit`` over a ``BucketSentenceIter`` ends where the
  reference's does.
- ``rnn_io``: ``build_vocab``, ``encode_sentences`` and
  ``BucketSentenceIter``'s batches, bucket keys and order bit for bit.
- ``models.lstm_unroll_symbol``'s JSON byte-equal to the reference's
  ``lstm_unroll`` under fresh ``NameManager``s.
- ``NDArray.asnumpy`` returns a copy (ROADMAP §C16): a CPU array's host
  view must not follow later in-place updates.
"""

import numpy as np
import pytest

import torch_port_fixtures  # noqa: F401  (puts the repo on sys.path)

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

V, E, H, L, N = 20, 8, 8, 2, 4
PARAM_TOL = 2e-6
SGD = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-5))


def _lm(M):
    data = M.sym.Variable("data")
    emb = M.sym.Embedding(data, input_dim=V, output_dim=E, name="embed")
    rnn = M.sym.RNN(M.sym.SwapAxis(emb, dim1=0, dim2=1), state_size=H,
                    num_layers=L, mode="lstm", name="lstm")
    flat = M.sym.Reshape(M.sym.SwapAxis(rnn, dim1=0, dim2=1), shape=(-1, H))
    fc = M.sym.FullyConnected(flat, num_hidden=V, name="cls")
    label = M.sym.Reshape(M.sym.Variable("softmax_label"), shape=(-1,))
    return M.sym.SoftmaxOutput(fc, label, name="softmax")


def _sym_gen(M):
    def sym_gen(key):
        with M.sym.NameManager():
            return _lm(M), ["data"], ["softmax_label"]
    return sym_gen


def _params(seed=0):
    net = _lm(mt)
    shapes, _, _ = net.infer_shape(data=(N, 16), softmax_label=(N, 16))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.2).astype(np.float32)
            for n, s in zip(net.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}


def _module(M, params, default=16):
    bm = M.mod.BucketingModule(_sym_gen(M), default_bucket_key=default,
                               context=M.cpu())
    bm.bind([("data", (N, default))], [("softmax_label", (N, default))])
    bm.init_params(arg_params={k: M.nd.array(v) for k, v in params.items()})
    bm.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    return bm


def _batch(M, T, seed):
    rng = np.random.RandomState(seed)
    d = rng.randint(0, V, (N, T)).astype(np.float32)
    lab = rng.randint(0, V, (N, T)).astype(np.float32)
    return M.io.DataBatch(
        [M.nd.array(d)], [M.nd.array(lab)], bucket_key=T,
        provide_data=[M.io.DataDesc("data", (N, T))],
        provide_label=[M.io.DataDesc("softmax_label", (N, T))])


def _step(bm, db):
    bm.forward(db, is_train=True)
    bm.backward()
    bm.update()


def _values(bm):
    return {k: v.asnumpy() for k, v in bm.get_params()[0].items()}


def _assert_params(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_TOL,
                                   err_msg=k)


def _ptrs(module):
    exe = module._exec_group.execs[0]
    return {n: exe.arg_dict[n]._data.data_ptr() for n in module._param_names}


def test_bucketing_module_matches_reference_over_buckets():
    params = _params()
    runs = {}
    for M in (mx, mt):
        with M.cpu():
            bm = _module(M, params)
            runs[M] = []
            for i, T in enumerate((16, 8, 16, 8)):
                _step(bm, _batch(M, T, seed=i))
                runs[M].append((_values(bm),
                                bm.get_outputs()[0].asnumpy()))
            if M is mt:
                port = bm
    for (got, out), (want, ref_out) in zip(runs[mt], runs[mx]):
        _assert_params(got, want)
        np.testing.assert_allclose(out, ref_out, rtol=0, atol=1e-5)
    # both buckets alias one set of parameter arrays
    assert sorted(port._buckets) == [8, 16]
    assert _ptrs(port._buckets[8]) == _ptrs(port._buckets[16])


def test_switch_after_update_sees_trained_values_and_shared_module():
    params = _params(seed=1)
    outs = {}
    for M in (mx, mt):
        with M.cpu():
            bm = _module(M, params)
            _step(bm, _batch(M, 16, seed=5))
            trained = _values(bm)
            bm.switch_bucket(8, [("data", (N, 8))],
                             [("softmax_label", (N, 8))])
            small = bm._curr_module._exec_group.execs[0].arg_dict
            for k, v in trained.items():
                np.testing.assert_array_equal(small[k].asnumpy(), v)
            # an external BucketingModule sharing the parameters and the
            # optimizer: an update through it is seen by the first
            other = M.mod.BucketingModule(_sym_gen(M), default_bucket_key=16,
                                          context=M.cpu())
            other.bind([("data", (N, 16))], [("softmax_label", (N, 16))],
                       shared_module=bm)
            assert other.params_initialized and other.optimizer_initialized
            _step(other, _batch(M, 8, seed=6))
            after = _values(bm)
            for k, v in _values(other).items():
                np.testing.assert_array_equal(after[k], v)
            outs[M] = after
            if M is mt:
                assert (_ptrs(other._buckets[16])
                        == _ptrs(bm._buckets[16]))
    _assert_params(outs[mt], outs[mx])


def _sentences(seed=0, n=60, vocab=V - 1):
    rng = np.random.RandomState(seed)
    return [[f"w{int(t)}" for t in rng.randint(0, vocab,
                                               int(rng.randint(3, 17)))]
            for _ in range(n)]


def test_bucket_sentence_iter_matches_reference_bit_for_bit():
    raw = _sentences()
    vocab = mt.rnn_io.build_vocab(raw)
    assert vocab == mx.rnn_io.build_vocab(raw)
    enc = mt.rnn_io.encode_sentences(raw, vocab)
    assert enc == mx.rnn_io.encode_sentences(raw, vocab)
    states = [("l0_init_c", (N, H)), ("l0_init_h", (N, H))]
    its = {}
    for M in (mx, mt):
        with M.cpu():
            its[M] = M.rnn_io.BucketSentenceIter(
                enc, N, buckets=[8, 12, 16], init_states=states, seed=3)
    a, b = its[mx], its[mt]
    assert a.buckets == b.buckets and a.default_bucket_key == 16
    assert ([(d.name, tuple(d.shape)) for d in b.provide_data]
            == [(d.name, tuple(d.shape)) for d in a.provide_data])
    for epoch in range(2):
        ref = list(a)
        with mt.cpu():          # batches land on the current context
            got = list(b)
        assert len(got) == len(ref) > 3
        for x, y in zip(got, ref):
            assert x.bucket_key == y.bucket_key
            for p, q in zip(x.data + x.label, y.data + y.label):
                np.testing.assert_array_equal(p.asnumpy(), q.asnumpy())
            assert ([(d.name, tuple(d.shape)) for d in x.provide_data]
                    == [(d.name, tuple(d.shape)) for d in y.provide_data])
        a.reset()
        b.reset()


def test_fit_over_bucket_sentence_iter_matches_reference():
    """``fit`` through BaseModule with the bucketed iterator, one epoch:
    the parameters end where the reference's do."""
    rng = np.random.RandomState(4)
    enc = [list(rng.randint(1, V, int(rng.randint(3, 17))))
           for _ in range(40)]
    params = _params(seed=2)
    ends = {}
    for M in (mx, mt):
        with M.cpu():
            it = M.rnn_io.BucketSentenceIter(enc, N, buckets=[8, 16], seed=1)
            bm = M.mod.BucketingModule(_sym_gen(M), default_bucket_key=16,
                                       context=M.cpu())
            bm.fit(it, num_epoch=1, eval_metric="ce",
                   arg_params={k: M.nd.array(v) for k, v in params.items()},
                   optimizer="sgd", optimizer_params=dict(SGD))
            ends[M] = _values(bm)
            assert sorted(bm._buckets) == [8, 16]
    _assert_params(ends[mt], ends[mx])


@pytest.mark.parametrize("layers,dropout", [(1, 0.0), (2, 0.0), (2, 0.5)])
def test_lstm_unroll_symbol_json_matches_reference(layers, dropout):
    kw = dict(num_lstm_layer=layers, seq_len=5, input_size=30,
              num_hidden=8, num_embed=6, num_label=30, dropout=dropout)
    with mx.sym.NameManager():
        ref = mx.models.lstm_unroll(**kw)
    with mt.sym.NameManager():
        got = mt.models.lstm_unroll_symbol(**kw)
    assert got.tojson() == ref.tojson()
    assert got.list_arguments() == ref.list_arguments()
    shapes = dict(data=(N, 5), softmax_label=(N, 5))
    shapes.update({f"l{i}_init_{k}": (N, 8) for i in range(layers)
                   for k in "ch"})
    assert got.infer_shape(**shapes) == ref.infer_shape(**shapes)


def test_asnumpy_is_a_copy_the_update_does_not_reach():
    """C16: on the CPU ``asnumpy`` gave a view of the array's storage, so
    a snapshot taken by ``get_params`` moved with the next update; the
    reference's is a copy."""
    with mt.cpu():
        arr = mt.nd.array(np.arange(6, dtype=np.float32))
        host = arr.asnumpy()
        arr[:] = -1.0
        np.testing.assert_array_equal(host, np.arange(6, dtype=np.float32))
        np.testing.assert_array_equal(np.asarray(arr), -np.ones(6))
        bm = _module(mt, _params(seed=3))
        before = _values(bm)
        _step(bm, _batch(mt, 16, seed=7))
        assert any(not np.array_equal(before[k], v)
                   for k, v in _values(bm).items())
        for k, v in _params(seed=3).items():
            np.testing.assert_array_equal(before[k], v)
