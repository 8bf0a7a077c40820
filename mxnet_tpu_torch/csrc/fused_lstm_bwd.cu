// The fused-LSTM backward kernel (fused_rnn.cuh, G 4) behind its C entry
// point.  One translation unit per kernel, so that nvcc builds the four at
// once.
//   mxtt_lstm_bwd <- mxnet_tpu/ops/pallas_lstm.py _bwd_call (call :216)

#include "fused_rnn.cuh"

extern "C" int mxtt_lstm_bwd(int dtype, const void* acts, const void* cells,
                             const void* ys, const void* h0, const void* c0,
                             const void* wh, const void* dys, const void* dhT,
                             const void* dcT, void* dgx, void* xbuf,
                             void* dwh, void* dbh, void* dh0, void* dc0, int T,
                             int N, int H, void* stream) {
  return rnn_bwd_entry<4>(dtype, acts, cells, ys, h0, c0, wh, dys, dhT, dcT,
                          dgx, xbuf, dwh, dbh, dh0, dc0, T, N, H, stream);
}
