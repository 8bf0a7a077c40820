// The fused-LSTM forward kernel (fused_rnn.cuh, G 4) behind its C entry
// point, and the barrier floor the timings set beside the kernels.  One
// translation unit per kernel, so that nvcc builds the four at once.
//   mxtt_lstm_fwd <- mxnet_tpu/ops/pallas_lstm.py _fwd (call :126)

#include "fused_rnn.cuh"

extern "C" int mxtt_lstm_fwd(int dtype, const void* gx, const void* h0,
                             const void* c0, const void* wh, const void* bh,
                             void* ys, void* hT, void* cT, void* acts,
                             void* cells, int T, int N, int H, int save,
                             void* stream) {
  return rnn_fwd_entry<4>(dtype, gx, h0, c0, wh, bh, ys, hT, cT, acts, cells,
                          T, N, H, save, stream);
}

namespace {
__global__ void barrier_floor_kernel(int T) {
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) grid.sync();
}
}  // namespace

// An empty cooperative kernel of T grid barriers over the kernels' grid at
// width H: the serial floor no bound column covers.
extern "C" int mxtt_rnn_barrier_floor(int T, int H, void* stream) {
  const Geo g = make_geo(4, T, 1, H, 0);
  int t = T;
  void* args[] = {&t};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)barrier_floor_kernel, dim3(g.P), dim3(NT), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
