// What the flash tensor-core kernels (flash_fwd_tc.cu, flash_dq_tc.cu,
// flash_dkv_tc.cu, flash_dkv_f32tc.cu) share: the call's geometry and mask
// (Geo, from the C entry points' dims), a tensor's element strides (Str),
// the reference's mask rules (_mask_for: keep; _tile_live: tile_live;
// tile_full: every score of a tile kept, so the per-element test can be
// skipped), exp2_ftz, and the entry points' host helpers.

#pragma once

#include <stdint.h>

namespace flash {

struct Geo {
  int B, Hq, Hkv, Sq, Sk, D, group;
  int causal, window, qo, ko;
  float scale;
};

// element strides of a 4-D tensor: batch, head, sequence (last dim is 1)
struct Str {
  long long b, h, s;
};

// _mask_for: keep score (q row qi, k row kj) of global positions
// qo + qi and ko + kj
__device__ __forceinline__ bool keep(const Geo& g, int qi, int kj) {
  const int qp = g.qo + qi, kp = g.ko + kj;
  if (g.causal) {
    if (qp < kp) return false;
    return !g.window || qp - kp < g.window;
  }
  if (g.window) return qp - kp < g.window && kp - qp < g.window;
  return true;
}

// _tile_live: the tile of q positions [q_lo, q_hi] x k positions
// [k_lo, k_hi] holds at least one kept score
__device__ __forceinline__ bool tile_live(const Geo& g, int q_lo, int q_hi,
                                          int k_lo, int k_hi) {
  bool live = true;
  if (g.causal) live = live && q_hi >= k_lo;
  if (g.window) {
    live = live && q_lo - k_hi < g.window;
    if (!g.causal) live = live && k_lo - q_hi < g.window;
  }
  return live;
}

// every score of the tile is kept: the per-element test can be skipped
__device__ __forceinline__ bool tile_full(const Geo& g, int q_lo, int q_hi,
                                          int k_lo, int k_hi) {
  if (g.causal) return q_lo >= k_hi && (!g.window || q_hi - k_lo < g.window);
  if (g.window) return q_hi - k_lo < g.window && k_hi - q_lo < g.window;
  return true;
}

// 2^x in one MUFU op; results below 2^-126 flush to 0 (a p that small
// is below float32's resolution of l >= 1 anyway)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dims: B, Hq, Hkv, Sq, Sk, D
inline Geo make_geo(const int* dims, int causal, int window, int qo, int ko,
                    float scale) {
  Geo g;
  g.B = dims[0];
  g.Hq = dims[1];
  g.Hkv = dims[2];
  g.Sq = dims[3];
  g.Sk = dims[4];
  g.D = dims[5];
  g.group = g.Hkv > 0 ? g.Hq / g.Hkv : 0;
  g.causal = causal;
  g.window = window;
  g.qo = qo;
  g.ko = ko;
  g.scale = scale;
  return g;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the strides of tensor i: 3 per tensor (batch, head, sequence)
inline Str str_at(const long long* s, int i) {
  Str r;
  r.b = s[3 * i];
  r.h = s[3 * i + 1];
  r.s = s[3 * i + 2];
  return r;
}

}  // namespace flash
