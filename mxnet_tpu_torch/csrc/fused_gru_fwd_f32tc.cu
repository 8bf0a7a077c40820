// The fused-GRU forward in float32 on tensor cores through split-TF32
// products (fused_rnn_fwd_f32tc.cuh, G 3; no cell: c0, cT and cells are
// null) behind its C entry point.
//   mxtt_gru_fwd_f32tc <- mxnet_tpu/ops/pallas_gru.py _fwd (call :94)

#include "fused_rnn_fwd_f32tc.cuh"

extern "C" int mxtt_gru_fwd_f32tc(const void* gx, const void* h0,
                                  const void* c0, const void* wh,
                                  const void* bh, void* ys, void* hT,
                                  void* cT, void* acts, void* cells,
                                  void* ctr, int T, int N, int H, int save,
                                  int* info, void* stream) {
  return rnn_tc::f32fwd::rnn_fwd_f32tc_entry<3>(gx, h0, c0, wh, bh, ys, hT,
                                                cT, acts, cells, ctr, T, N, H,
                                                save, info, stream);
}
