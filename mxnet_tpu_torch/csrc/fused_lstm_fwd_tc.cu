// The fused-LSTM forward on bf16 tensor cores (fused_rnn_fwd_tc.cuh, G 4)
// behind its C entry point.
//   mxtt_lstm_fwd_tc <- mxnet_tpu/ops/pallas_lstm.py _fwd (call :126)

#include "fused_rnn_fwd_tc.cuh"

extern "C" int mxtt_lstm_fwd_tc(const void* gx, const void* h0,
                                const void* c0, const void* wh,
                                const void* bh, void* ys, void* hT, void* cT,
                                void* acts, void* cells, void* ctr, int T,
                                int N, int H, int save, int* info,
                                void* stream) {
  return rnn_tc::rnn_fwd_tc_entry<4>(gx, h0, c0, wh, bh, ys, hT, cT, acts,
                                     cells, ctr, T, N, H, save, info, stream);
}
