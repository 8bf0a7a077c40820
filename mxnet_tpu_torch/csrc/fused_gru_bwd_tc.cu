// The fused-GRU backward on bf16 tensor cores (fused_rnn_bwd_tc.cuh, G 3;
// no cell: cells, c0, dcT and dc0 are null) behind its C entry point.
//   mxtt_gru_bwd_tc <- mxnet_tpu/ops/pallas_gru.py _bwd_call (call :169)

#include "fused_rnn_bwd_tc.cuh"

extern "C" int mxtt_gru_bwd_tc(const void* acts, const void* cells,
                               const void* ys, const void* h0, const void* c0,
                               const void* wh, const void* dys,
                               const void* dhT, const void* dcT, void* dgx,
                               void* xbuf, void* dwh, void* dbh, void* dh0,
                               void* dc0, void* ctr, int T, int N, int H,
                               int* info, void* stream) {
  return rnn_tc::rnn_bwd_tc_entry<3>(acts, cells, ys, h0, c0, wh, dys, dhT,
                                     dcT, dgx, xbuf, dwh, dbh, dh0, dc0, ctr,
                                     T, N, H, info, stream);
}
