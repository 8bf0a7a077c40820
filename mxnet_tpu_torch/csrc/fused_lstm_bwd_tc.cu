// The fused-LSTM backward on bf16 tensor cores (fused_rnn_bwd_tc.cuh, G 4)
// behind its C entry point, and the floor of its split barrier.
//   mxtt_lstm_bwd_tc <- mxnet_tpu/ops/pallas_lstm.py _bwd_call (call :216)

#include "fused_rnn_bwd_tc.cuh"

extern "C" int mxtt_lstm_bwd_tc(const void* acts, const void* cells,
                                const void* ys, const void* h0,
                                const void* c0, const void* wh,
                                const void* dys, const void* dhT,
                                const void* dcT, void* dgx, void* xbuf,
                                void* dwh, void* dbh, void* dh0, void* dc0,
                                void* ctr, int T, int N, int H, int* info,
                                void* stream) {
  return rnn_tc::rnn_bwd_tc_entry<4>(acts, cells, ys, h0, c0, wh, dys, dhT,
                                     dcT, dgx, xbuf, dwh, dbh, dh0, dc0, ctr,
                                     T, N, H, info, stream);
}

// T arrive/wait pairs of the split barrier over the launch the LSTM kernel
// takes at (N, H): same grid, clusters and shared memory.  ctr is one
// zeroed unsigned; info receives (cluster size, grid CTAs, bytes).
extern "C" int mxtt_rnn_split_barrier_floor(int T, int N, int H, void* ctr,
                                            int* info, void* stream) {
  using namespace rnn_tc;
  const TcGeo g = tc_geo(4, T, N, H);
  info[0] = CL, info[1] = up(g.P, CL), info[2] = g.total;
  int t = T;
  unsigned* c = static_cast<unsigned*>(ctr);
  void* args[] = {&t, &c};
  if (!tc_geo_ok(g)) return (int)cudaErrorInvalidValue;
  return (int)tc_launch(split_barrier_floor_kernel, up(g.P, CL), g.total,
                        args, static_cast<cudaStream_t>(stream));
}
