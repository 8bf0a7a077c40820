// The fused-GRU forward kernel (fused_rnn.cuh, G 3; no cell: c0, cT and
// cells are null) behind its C entry point.  One translation unit per
// kernel, so that nvcc builds the four at once.
//   mxtt_gru_fwd <- mxnet_tpu/ops/pallas_gru.py _fwd (call :94)

#include "fused_rnn.cuh"

extern "C" int mxtt_gru_fwd(int dtype, const void* gx, const void* h0,
                            const void* c0, const void* wh, const void* bh,
                            void* ys, void* hT, void* cT, void* acts,
                            void* cells, int T, int N, int H, int save,
                            void* stream) {
  return rnn_fwd_entry<3>(dtype, gx, h0, c0, wh, bh, ys, hT, cT, acts, cells,
                          T, N, H, save, stream);
}
