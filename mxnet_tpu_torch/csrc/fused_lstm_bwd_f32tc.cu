// The fused-LSTM backward in float32 on tensor cores through split-TF32
// products (fused_rnn_bwd_f32tc.cuh, G 4) behind its C entry point.
//   mxtt_lstm_bwd_f32tc <- mxnet_tpu/ops/pallas_lstm.py _bwd_call (call :216)

#include "fused_rnn_bwd_f32tc.cuh"

extern "C" int mxtt_lstm_bwd_f32tc(const void* acts, const void* cells,
                                   const void* ys, const void* h0,
                                   const void* c0, const void* wh,
                                   const void* dys, const void* dhT,
                                   const void* dcT, void* dgx, void* xbuf,
                                   void* dwh, void* dbh, void* dh0, void* dc0,
                                   void* ctr, int T, int N, int H, int* info,
                                   void* stream) {
  return rnn_tc::f32::rnn_bwd_f32tc_entry<4>(
      acts, cells, ys, h0, c0, wh, dys, dhT, dcT, dgx, xbuf, dwh, dbh, dh0,
      dc0, ctr, T, N, H, info, stream);
}
