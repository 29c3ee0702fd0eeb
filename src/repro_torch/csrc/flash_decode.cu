// Flash-decode for Hopper (sm_90a), plain C interface: one query token per
// sequence against a KV cache, split over the cache (split-K).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// (_decode_kernel / flash_decode).  Same function: keys with kpos <= pos
// (and pos - kpos < window when a window is set) are attended, the logits
// are soft-capped and softmaxed online in float32; all G query heads of one
// KV head share one block.  The valid keys [lo, hi) are passed as ints, so
// one build serves every decode step, and keys outside them are never read.
//
// Bound.  Decode streams the valid part of the KV cache once per token:
// 2 flops per byte or less, so the card's memory rate bounds it.  What
// the design does about that:
//   - Split-K.  The grid is (n_split, KV, B).  Block `split` takes a
//     contiguous run of SPLIT_KEYS-key units of [lo, hi) (the Python
//     wrapper picks n_split so that the grid fills one wave of the card and
//     every split gets work; ref.split_ranges is the same arithmetic).
//     With n_split = 1 the block writes o itself and nothing else
//     launches; otherwise it writes float32 partials (acc, m, l) and a
//     small combine kernel merges them by log-sum-exp, one block per
//     (batch, head).
//   - Partials mode (flash_decode_partials).  A cache split by sequence
//     over several ranks: each rank runs the split kernel on its chunk
//     and keeps the partials, also with one split; the ranks' partials
//     are gathered and merged by the same combine kernel
//     (flash_decode_combine), which takes any number of them.  A chunk
//     with no valid key writes m = NEG_INF, l = 0.
//   - Loads in flight.  K/V tiles go through a 2-stage ring in shared
//     memory filled by 16-byte cp.async, so the next tile's loads overlap
//     this tile's math; the cache keeps its own element type (float32 or
//     bf16, independent of q) and is converted when read from shared
//     memory, never copied.  Tiles hold ~16 KB of K (BK keys).
//   - Each layout read along its unit stride.  The model's K cache is
//     (B,KV,hd,S), handed in as a strided (B,S,KV,hd) view with S at unit
//     stride: its tile is copied as rows of keys ([hd][BK]) and in the
//     logit phase threads walk keys, each accumulating q.k over d for its
//     key from conflict-free columns; every loaded K element serves the
//     block's G query heads.  A cache with hd at unit stride (V, and
//     contiguous caches) is copied as 16-byte runs along hd into padded
//     [BK][hd] tiles read as 16-byte vectors.  Other strides, and rows that
//     are not 16-byte aligned, take per-element loads.
//   - hd is a template parameter, so every loop over d unrolls.
// The products stay in float32 on the CUDA cores: float32 caches must
// agree to 2e-5, and at G <= 8 heads per KV head the arithmetic is below
// the memory bound.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;
using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT_KEYS = 128;  // split unit (ref.SPLIT_KEYS); a multiple of every BK
constexpr int MAX_SPLIT = 64;    // (flash_decode.MAX_SPLIT)
constexpr int MAX_PARTS = 1024;  // partials one combine merges (flash_decode.MAX_PARTS)

template <int HD, typename T>
struct Geo {
  static constexpr int E = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int BK_ = 16384 / (HD * (int)sizeof(T));
  static constexpr int BK = BK_ < 32 ? 32 : (BK_ > 128 ? 128 : BK_);  // keys per tile
  static constexpr int LDH = HD + E;           // padded row of a [BK][hd] tile
  static constexpr int KT = BK * LDH;          // K tile (either layout fits)
  static constexpr int VT = BK * LDH;
  static constexpr int STAGE = KT + VT;        // elements of one ring stage
  static constexpr int LT = THREADS / BK;      // threads per key (logits)
  static constexpr int DT = HD < THREADS ? HD : THREADS;  // d lanes (P.V)
  static constexpr int GT = THREADS / DT;      // head lanes (P.V)
  // heads per pass of each phase: a thread's heads are g0, g0 + LT, ...
  // (logits) or g0, g0 + GT, ... (P.V); sized so that G ~ 8 heads per KV
  // head take one pass with few idle slots
  static constexpr int NCL = LT >= 8 ? 1 : 8 / LT;
  static constexpr int NCV = GT >= 8 ? 1 : 8 / GT;
  static_assert(SPLIT_KEYS % BK == 0, "split units hold whole tiles");
  static_assert(BK * HD / E % THREADS == 0, "tile copy is uniform");
};

template <int HD, typename T>
constexpr size_t smem_bytes(int G) {
  using Gm = Geo<HD, T>;
  return 2 * sizeof(T) * Gm::STAGE +
         sizeof(float) * ((size_t)2 * G * HD + (size_t)G * Gm::BK + 3 * G);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with in == false nothing is read and the 16 bytes
// are zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
// 4-byte async copy (a float32 key at the edge of the range), zero-filled
// when in == false
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const bf16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Copy keys [kt, kt + BK) of a cache into a [BK][LDH] tile (keys as rows);
// keys outside [start, end) are zero-filled and not read.  vec: head_dim
// at unit stride and every row 16-byte aligned.
template <int HD, typename T>
__device__ __forceinline__ void load_key_rows(T* dst, const T* src,
                                              long long ss, long long sd,
                                              int kt, int start, int end,
                                              bool vec) {
  using Gm = Geo<HD, T>;
  constexpr int E = Gm::E, BK = Gm::BK, LDH = Gm::LDH, CPR = HD / E;
  if (vec) {
#pragma unroll
    for (int u = 0; u < BK * CPR / THREADS; ++u) {
      const int c = threadIdx.x + u * THREADS;
      const int j = c / CPR, d = (c % CPR) * E, key = kt + j;
      const bool in = key >= start && key < end;
      cp_async16(dst + j * LDH + d, in ? src + key * ss + d : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
      const int j = i / HD, d = i % HD, key = kt + j;
      dst[j * LDH + d] = key >= start && key < end ? src[key * ss + d * sd]
                                                   : from_f<T>(0.f);
    }
  }
}

// Copy keys [kt, kt + BK) of a cache whose key axis has unit stride into
// a [HD][BK] tile (rows of keys); keys outside [start, end) are
// zero-filled and not read.  vec: every d-row 16-byte aligned.
template <int HD, typename T>
__device__ __forceinline__ void load_key_cols(T* dst, const T* src,
                                              long long sd, int kt,
                                              int start, int end, bool vec) {
  using Gm = Geo<HD, T>;
  constexpr int E = Gm::E, BK = Gm::BK, CPR = BK / E;
#pragma unroll
  for (int u = 0; u < HD * CPR / THREADS; ++u) {
    const int c = threadIdx.x + u * THREADS;
    const int d = c / CPR, j = (c % CPR) * E, k0 = kt + j;
    T* dp = dst + d * BK + j;
    const T* sp = src + d * sd + k0;
    if (vec && k0 >= start && k0 + E <= end) {
      cp_async16(dp, sp, true);
    } else {  // the edges of the range: float32 keys still copy async
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const bool in = k0 + e >= start && k0 + e < end;
        if constexpr (sizeof(T) == 4)
          cp_async4(dp + e, in ? sp + e : src, in);
        else
          dp[e] = in ? sp[e] : from_f<T>(0.f);
      }
    }
  }
}

template <int HD, typename T, bool KSEQ>
__global__ void __launch_bounds__(THREADS)
fd_split_kernel(const void* __restrict__ q, int q_bf16,
                const T* __restrict__ k, const T* __restrict__ v,
                void* __restrict__ o, float* __restrict__ part, int B, int NH,
                int G, int lo, int hi, long long k_sb, long long k_ss,
                long long k_sh, long long k_sd, long long v_sb,
                long long v_ss, long long v_sh, long long v_sd, int kvec,
                int vvec, float scale, float softcap, int to_part) {
  using Gm = Geo<HD, T>;
  constexpr int BK = Gm::BK, LDH = Gm::LDH, E = Gm::E, LT = Gm::LT;
  constexpr int DT = Gm::DT, GT = Gm::GT, NCL = Gm::NCL, NCV = Gm::NCV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);    // 2 x (K tile, V tile)
  float* qs = reinterpret_cast<float*>(smem_raw + 2 * sizeof(T) * Gm::STAGE);
  float* acc = qs + G * HD;   // G x HD, unnormalized output
  float* ps = acc + G * HD;   // G x BK logits, then probabilities
  float* ms = ps + G * BK;    // G running max
  float* ls = ms + G;         // G running denominator
  float* as = ls + G;         // G rescale factor of the current tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, n_split = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;

  // this block's keys: units [us, ue) of the valid range (ref.split_ranges)
  const int u0 = lo / SPLIT_KEYS;
  const int nu = (hi + SPLIT_KEYS - 1) / SPLIT_KEYS - u0;
  const int us = u0 + (int)((long long)split * nu / n_split);
  const int ue = u0 + (int)((long long)(split + 1) * nu / n_split);
  const int start = max(lo, us * SPLIT_KEYS), end = min(hi, ue * SPLIT_KEYS);
  const int kt0 = start / BK * BK;
  const int ntiles = end > start ? (end - kt0 + BK - 1) / BK : 0;

  const long long row0 = (long long)b * NH + (long long)kvh * G;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  auto issue = [&](int it) {
    T* ks = ring + (it & 1) * Gm::STAGE;
    const int kt = kt0 + it * BK;
    if (KSEQ)
      load_key_cols<HD>(ks, kb, k_sd, kt, start, end, kvec);
    else
      load_key_rows<HD>(ks, kb, k_ss, k_sd, kt, start, end, kvec);
    load_key_rows<HD>(ks + Gm::KT, vb, v_ss, v_sd, kt, start, end, vvec);
    cp_async_commit();
  };
  if (ntiles > 0) issue(0);  // in flight while q is read

  for (int i = tid; i < G * HD; i += THREADS) {
    const long long qi = row0 * HD + i;
    const float x = q_bf16 ? to_f(static_cast<const bf16*>(q)[qi])
                           : static_cast<const float*>(q)[qi];
    qs[i] = x * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` has landed (and q, m, l are set)
    const T* ks = ring + (it & 1) * Gm::STAGE;
    const T* vs = ks + Gm::KT;
    const int kt = kt0 + it * BK;

    {  // logits: thread -> key j, heads gl, gl + LT, ...
      const int j = tid % BK, gl = tid / BK;
      const int kpos = kt + j;
      const bool in = kpos >= start && kpos < end;
      for (int gb = gl; gb < G; gb += NCL * LT) {
        const float* qr[NCL];
#pragma unroll
        for (int u = 0; u < NCL; ++u) qr[u] = qs + min(gb + u * LT, G - 1) * HD;
        float s[NCL];
#pragma unroll
        for (int u = 0; u < NCL; ++u) s[u] = 0.f;
#pragma unroll
        for (int d0 = 0; d0 < HD; d0 += E) {
          float kf[E];
          if (KSEQ) {
#pragma unroll
            for (int e = 0; e < E; ++e) kf[e] = to_f(ks[(d0 + e) * BK + j]);
          } else {
            load16(ks + j * LDH + d0, kf);
          }
#pragma unroll
          for (int u = 0; u < NCL; ++u) {
#pragma unroll
            for (int e = 0; e < E; e += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qr[u] + d0 + e);
              s[u] = fmaf(q4.x, kf[e], s[u]);
              s[u] = fmaf(q4.y, kf[e + 1], s[u]);
              s[u] = fmaf(q4.z, kf[e + 2], s[u]);
              s[u] = fmaf(q4.w, kf[e + 3], s[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < NCL; ++u) {
          const int g = gb + u * LT;
          if (g < G)
            ps[g * BK + j] = in ? repro::apply_softcap(s[u], softcap)
                                : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax per head: warp w takes heads w, w + WARPS, ...
    for (int g = warp; g < G; g += WARPS) {
      float* row = ps + g * BK;
      float mx = ms[g];
      for (int jj = lane; jj < BK; jj += 32) mx = fmaxf(mx, row[jj]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int jj = lane; jj < BK; jj += 32) {
        const float p = expf(row[jj] - mx);
        row[jj] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(ms[g] - mx);
        ls[g] = ls[g] * alpha + sum;
        ms[g] = mx;
        as[g] = alpha;
      }
    }
    __syncthreads();

    {  // P.V: thread -> column d, heads gv, gv + GT, ...
      const int dl = tid % DT, gv = tid / DT;
#pragma unroll
      for (int nd = 0; nd < HD / DT; ++nd) {
        const int d = dl + nd * DT;
        for (int gb = gv; gb < G; gb += NCV * GT) {
          const float* pr[NCV];
#pragma unroll
          for (int u = 0; u < NCV; ++u)
            pr[u] = ps + min(gb + u * GT, G - 1) * BK;
          float pv[NCV];
#pragma unroll
          for (int u = 0; u < NCV; ++u) pv[u] = 0.f;
#pragma unroll 4
          for (int jj = 0; jj < BK; jj += 4) {
            float vv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) vv[i] = to_f(vs[(jj + i) * LDH + d]);
#pragma unroll
            for (int u = 0; u < NCV; ++u) {
              const float4 p4 = *reinterpret_cast<const float4*>(pr[u] + jj);
              pv[u] = fmaf(p4.x, vv[0], pv[u]);
              pv[u] = fmaf(p4.y, vv[1], pv[u]);
              pv[u] = fmaf(p4.z, vv[2], pv[u]);
              pv[u] = fmaf(p4.w, vv[3], pv[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < NCV; ++u) {
            const int g = gb + u * GT;
            if (g < G) acc[g * HD + d] = acc[g * HD + d] * as[g] + pv[u];
          }
        }
      }
    }
    __syncthreads();  // ps, as and this stage are reused
  }
  __syncthreads();  // (a block with no keys: the initial state is set)

  if (n_split == 1 && !to_part) {  // the only split: write o in q's type
    for (int i = tid; i < G * HD; i += THREADS) {
      const float x = acc[i] / fmaxf(ls[i / HD], 1e-30f);
      if (q_bf16)
        static_cast<bf16*>(o)[row0 * HD + i] = from_f<bf16>(x);
      else
        static_cast<float*>(o)[row0 * HD + i] = x;
    }
  } else {  // partials: acc (n_split,B,NH,HD), then m, l (n_split,B,NH)
    const long long BNH = (long long)B * NH;
    float* pa = part + ((long long)split * BNH + row0) * HD;
    for (int i = tid; i < G * HD; i += THREADS) pa[i] = acc[i];
    float* pm = part + n_split * BNH * HD + split * BNH + row0;
    for (int g = tid; g < G; g += THREADS) {
      pm[g] = ms[g];
      pm[n_split * BNH + g] = ls[g];
    }
  }
}

// Merge the n_split partials of one (batch, head) row by log-sum-exp:
// acc (n_split, BNH, hd), pm and pl (n_split, BNH).  A split whose keys
// were all masked, or that got no keys, has m = NEG_INF (finite, never
// -inf) and l = 0: M = max m_i is finite, so exp(m_i - M) is never NaN
// and such a split weighs 0 next to any split with keys.
__global__ void __launch_bounds__(THREADS)
fd_combine_kernel(const float* __restrict__ acc, const float* __restrict__ pm,
                  const float* __restrict__ pl, void* __restrict__ o,
                  int q_bf16, int n_split, int BNH, int hd) {
  __shared__ float w[MAX_PARTS];
  __shared__ float inv_l;
  const long long row = blockIdx.x;
  if (threadIdx.x == 0) {
    float M = NEG_INF;
    for (int i = 0; i < n_split; ++i)
      M = fmaxf(M, pm[(long long)i * BNH + row]);
    float L = 0.f;
    for (int i = 0; i < n_split; ++i) {
      w[i] = expf(pm[(long long)i * BNH + row] - M);
      L += w[i] * pl[(long long)i * BNH + row];
    }
    inv_l = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float a = 0.f;
    for (int i = 0; i < n_split; ++i)
      a = fmaf(w[i], acc[((long long)i * BNH + row) * hd + d], a);
    if (q_bf16)
      static_cast<bf16*>(o)[row * hd + d] = from_f<bf16>(a * inv_l);
    else
      static_cast<float*>(o)[row * hd + d] = a * inv_l;
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* part;
  int q_bf16, B, NH, KV, lo, hi, n_split, kvec, vvec;
  long long ks[4], vs[4];  // (batch, seq, head, head_dim) strides
  float scale, softcap;
  cudaStream_t stream;
  int to_part;  // keep the partials (no combine), also with one split
};

cudaError_t launch_combine(const float* acc, const float* pm,
                           const float* pl, void* o, int q_bf16, int n,
                           int BNH, int hd, cudaStream_t stream) {
  fd_combine_kernel<<<BNH, THREADS, 0, stream>>>(acc, pm, pl, o, q_bf16, n,
                                                 BNH, hd);
  return cudaGetLastError();
}

// With occ != nullptr: report the block's shared memory and how many
// blocks fit on one SM; otherwise launch.
template <int HD, typename T, bool KSEQ>
cudaError_t run(const Args& a, int* occ, long long* smem_out) {
  const int G = a.NH / a.KV;
  const size_t smem = smem_bytes<HD, T>(G);
  auto kern = fd_split_kernel<HD, T, KSEQ>;
  if (occ) *smem_out = (long long)smem;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (occ)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(occ, kern, THREADS,
                                                         smem);
  dim3 grid(a.n_split, a.KV, a.B);
  kern<<<grid, THREADS, smem, a.stream>>>(
      a.q, a.q_bf16, static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.o, a.part, a.B, a.NH, G, a.lo, a.hi, a.ks[0], a.ks[1], a.ks[2],
      a.ks[3], a.vs[0], a.vs[1], a.vs[2], a.vs[3], a.kvec, a.vvec, a.scale,
      a.softcap, a.to_part);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.n_split == 1 || a.to_part) return e;
  const long long BNH = (long long)a.B * a.NH;
  const float* pm = a.part + a.n_split * BNH * HD;
  return launch_combine(a.part, pm, pm + a.n_split * BNH, a.o, a.q_bf16,
                        a.n_split, (int)BNH, HD, a.stream);
}

template <typename T>
cudaError_t dispatch(int hd, int kseq, const Args& a, int* occ,
                     long long* smem) {
#define REPRO_FD_CASE(HD)                               \
  case HD:                                              \
    return kseq ? run<HD, T, true>(a, occ, smem)        \
                : run<HD, T, false>(a, occ, smem);
  switch (hd) {
    REPRO_FD_CASE(16)
    REPRO_FD_CASE(32)
    REPRO_FD_CASE(64)
    REPRO_FD_CASE(128)
    REPRO_FD_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FD_CASE
}

cudaError_t dispatch_kv(int kv_dtype, int hd, int kseq, const Args& a,
                        int* occ = nullptr, long long* smem = nullptr) {
  if (kv_dtype == repro::kFloat32)
    return dispatch<float>(hd, kseq, a, occ, smem);
  if (kv_dtype == repro::kBFloat16)
    return dispatch<bf16>(hd, kseq, a, occ, smem);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory of one split block (bytes) and how many such blocks fit
// on one SM (0 with an error code if the block does not fit at all).  The
// wrapper asks once per (G, hd, cache dtype, K layout) and keeps the
// answer.
int flash_decode_occupancy(int G, int hd, int kv_dtype, int kseq,
                           long long* smem, int* blocks_per_sm) {
  Args a{};
  a.NH = G;
  a.KV = 1;
  *blocks_per_sm = 0;
  *smem = 0;
  return dispatch_kv(kv_dtype, hd, kseq, a, blocks_per_sm, smem);
}

// q and o: contiguous (B, NH, hd).  k, v: (B, S, KV, hd) with any strides
// (elements), given as (batch, seq, head, head_dim).  Keys [lo, hi) are
// attended.  kseq: K is read with its seq axis at unit stride; kvec/vvec:
// 16-byte copies are allowed (unit stride along the copied axis, rows
// 16-byte aligned).  part: float32 scratch of n_split * B * NH * (hd + 2)
// (unused with n_split == 1).
int flash_decode(const void* q, const void* k, const void* v, void* o,
                 float* part, int q_dtype, int kv_dtype, int B, int NH,
                 int KV, int hd, int lo, int hi, int n_split, long long k_sb,
                 long long k_ss, long long k_sh, long long k_sd,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long v_sd, int kseq, int kvec, int vvec, float scale,
                 float softcap, void* stream) {
  if (q_dtype != repro::kFloat32 && q_dtype != repro::kBFloat16)
    return cudaErrorInvalidValue;
  if (n_split < 1 || n_split > MAX_SPLIT) return cudaErrorInvalidValue;
  Args a{q, k, v, o, part, q_dtype == repro::kBFloat16, B, NH, KV, lo, hi,
         n_split, kvec, vvec, {k_sb, k_ss, k_sh, k_sd},
         {v_sb, v_ss, v_sh, v_sd}, scale, softcap,
         static_cast<cudaStream_t>(stream), 0};
  return dispatch_kv(kv_dtype, hd, kseq, a);
}

// Partials mode: the split kernel over keys [lo, hi) of a cache chunk (the
// arguments of flash_decode, without o), writing float32 partials into
// part, n_split * B * NH * (hd + 2): acc (n_split, B, NH, hd), then m and
// l (n_split, B, NH); also with n_split == 1, and with lo == hi (no valid
// key: m = NEG_INF, l = 0, acc = 0).  No combine runs.
int flash_decode_partials(const void* q, const void* k, const void* v,
                          float* part, int q_dtype, int kv_dtype, int B,
                          int NH, int KV, int hd, int lo, int hi,
                          int n_split, long long k_sb, long long k_ss,
                          long long k_sh, long long k_sd, long long v_sb,
                          long long v_ss, long long v_sh, long long v_sd,
                          int kseq, int kvec, int vvec, float scale,
                          float softcap, void* stream) {
  if (q_dtype != repro::kFloat32 && q_dtype != repro::kBFloat16)
    return cudaErrorInvalidValue;
  if (n_split < 1 || n_split > MAX_SPLIT || lo < 0 || hi < lo)
    return cudaErrorInvalidValue;
  Args a{q, k, v, nullptr, part, q_dtype == repro::kBFloat16, B, NH, KV, lo,
         hi, n_split, kvec, vvec, {k_sb, k_ss, k_sh, k_sd},
         {v_sb, v_ss, v_sh, v_sd}, scale, softcap,
         static_cast<cudaStream_t>(stream), 1};
  return dispatch_kv(kv_dtype, hd, kseq, a);
}

// Merge n partials by log-sum-exp into o (BNH, hd) in q's type: acc
// (n, BNH, hd), m and l (n, BNH), each contiguous float32 (the ranks'
// partials of flash_decode_partials, gathered).  n <= MAX_PARTS.
int flash_decode_combine(const float* acc, const float* m, const float* l,
                         void* o, int q_dtype, int n, int BNH, int hd,
                         void* stream) {
  if (q_dtype != repro::kFloat32 && q_dtype != repro::kBFloat16)
    return cudaErrorInvalidValue;
  if (n < 1 || n > MAX_PARTS || BNH < 1 || hd < 1 || hd > THREADS)
    return cudaErrorInvalidValue;
  return launch_combine(acc, m, l, o, q_dtype == repro::kBFloat16, n, BNH,
                        hd, static_cast<cudaStream_t>(stream));
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
