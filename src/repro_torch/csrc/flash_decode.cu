// Flash-decode for Hopper (sm_90a), plain C interface: one query token per
// sequence against a KV cache.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_decode.py
// (_decode_kernel / flash_decode).  Same function: keys with kpos <= pos
// (and pos - kpos < window when a window is set) are attended, the logits
// are soft-capped, masked with NEG_INF, and softmaxed online in float32;
// all G query heads of one KV head share one program.  pos is a plain
// int argument, so one build serves every decode step.
//
// Design.  One block of 256 threads per (KV head, batch row) walks the
// cache in 64-key tiles from the window start to pos, so positions past
// pos are never read.  K/V tiles are staged in shared memory as float32;
// the loader (division-free, many loads in flight per thread) makes
// whichever axis has unit stride vary fastest across threads, so both the model's (B,KV,hd,S) K cache (read through a
// strided (B,S,KV,hd) view) and a (B,S,KV,hd) cache load coalesced.  The
// cache keeps its own element type (float32 or bf16) independent of q,
// and is converted per element on load, never copied.
//
// Bound.  Decode streams the valid part of the KV cache once per token:
// 2 flops per byte or less, so the card's memory rate bounds it.  With
// one block per (KV head, batch row) a small batch fills few of the 132
// SMs, so this first version is far from that bound at short caches and
// small batches; a split-K redesign is queued in the ROADMAP.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int BK = 64;  // keys per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__host__ __device__ inline size_t smem_floats(int G, int hd) {
  return 2 * (size_t)G * hd + 2 * (size_t)BK * (hd + 1) + (size_t)G * BK +
         3 * (size_t)G;
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

// Where thread `tid` reads and writes element u (u < hd / 4) of a
// (BK x hd) tile: key j0 + u * jstep, column d0 + u * dstep.  The axis
// with unit stride varies fastest across threads, so loads coalesce for
// both cache layouts; since hd divides THREADS, no division is left in
// the loop.
struct TileMap {
  int j0, d0, jstep, dstep;
  __device__ TileMap(int hd, long long sd) {
    const int t = threadIdx.x;
    if (sd == 1) {  // head_dim contiguous: threads walk d
      j0 = t / hd;
      d0 = t % hd;
      jstep = THREADS / hd;
      dstep = 0;
    } else {        // sequence contiguous: threads walk keys
      j0 = t % BK;
      d0 = t / BK;
      jstep = 0;
      dstep = THREADS / BK;
    }
  }
};

// Stage keys [kt, kt + BK) of the K and V caches into padded float tiles
// (keys at or past hi read as 0).  Each thread issues a chunk of loads of
// both caches before it stores any, so many loads are in flight.
template <typename TKV>
__device__ __forceinline__ void load_kv_tile(float* ks, float* vs,
                                             const TKV* kb, const TKV* vb,
                                             int kt, int hi, int hd,
                                             long long k_ss, long long k_sd,
                                             long long v_ss, long long v_sd,
                                             const TileMap& km,
                                             const TileMap& vm) {
  constexpr int CH = 16;
  const int LD = hd + 1, per = BK * hd / THREADS;
  for (int u0 = 0; u0 < per; u0 += CH) {
    float kx[CH], vx[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = u0 + c;
      const int kj = km.j0 + u * km.jstep, kd = km.d0 + u * km.dstep;
      const int vj = vm.j0 + u * vm.jstep, vd = vm.d0 + u * vm.dstep;
      const bool ok = u < per;
      kx[c] = ok && kt + kj < hi ? to_f(kb[(kt + kj) * k_ss + kd * k_sd])
                                 : 0.f;
      vx[c] = ok && kt + vj < hi ? to_f(vb[(kt + vj) * v_ss + vd * v_sd])
                                 : 0.f;
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int u = u0 + c;
      if (u < per) {
        ks[(km.j0 + u * km.jstep) * LD + km.d0 + u * km.dstep] = kx[c];
        vs[(vm.j0 + u * vm.jstep) * LD + vm.d0 + u * vm.dstep] = vx[c];
      }
    }
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
              const TKV* __restrict__ v, TQ* __restrict__ o, int S, int NH,
              int G, int hd, int pos, long long k_sb, long long k_ss,
              long long k_sh, long long k_sd, long long v_sb, long long v_ss,
              long long v_sh, long long v_sd, float scale, int window,
              float softcap) {
  extern __shared__ float smem[];
  const int LD = hd + 1;
  float* qs = smem;           // G x hd, pre-scaled q
  float* acc = qs + G * hd;   // G x hd
  float* ks = acc + G * hd;   // BK x LD
  float* vs = ks + BK * LD;   // BK x LD
  float* ss = vs + BK * LD;   // G x BK logits, then probabilities
  float* ms = ss + G * BK;    // G running max
  float* ls = ms + G;         // G running denominator
  float* as = ls + G;         // G rescale factor of the current tile

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const long long qoff = ((long long)b * NH + (long long)kvh * G) * hd;
  for (int i = tid; i < G * hd; i += THREADS) {
    qs[i] = to_f(q[qoff + i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  const TKV* kb = k + b * k_sb + kvh * k_sh;
  const TKV* vb = v + b * v_sb + kvh * v_sh;

  const int hi = min(S, pos + 1);  // keys past pos are masked: not read
  const int lo = window ? max(0, pos - window + 1) : 0;
  const int warp = tid / 32, lane = tid % 32;
  const TileMap km(hd, k_sd), vm(hd, v_sd);

  for (int kt = lo; kt < hi; kt += BK) {
    __syncthreads();  // the previous tile is consumed
    load_kv_tile(ks, vs, kb, vb, kt, hi, hd, k_ss, k_sd, v_ss, v_sd, km, vm);
    __syncthreads();

    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, j = i % BK;
      const int kpos = kt + j;
      float val = -INFINITY;  // past the end of the valid range
      if (kpos < hi) {
        const float* qr = qs + g * hd;
        const float* kr = ks + j * LD;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
        dot = repro::apply_softcap(dot, softcap);
        bool valid = kpos <= pos;
        if (window) valid = valid && (pos - kpos) < window;
        val = valid ? dot : NEG_INF;
      }
      ss[i] = val;
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {
      float* row = ss + g * BK;
      float mx = ms[g];
      for (int j = lane; j < BK; j += 32) mx = fmaxf(mx, row[j]);
      mx = warp_max(mx);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(row[j] - mx);
        row[j] = p;
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

    for (int i = tid; i < G * hd; i += THREADS) {
      const int g = i / hd, d = i % hd;
      const float* pr = ss + g * BK;
      float pv = 0.f;
      for (int j = 0; j < BK; ++j) pv = fmaf(pr[j], vs[j * LD + d], pv);
      acc[i] = acc[i] * as[g] + pv;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd;
    o[qoff + i] = from_f<TQ>(acc[i] / fmaxf(ls[g], 1e-30f));
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int NH, int KV, int hd, int pos,
                   const long long* st, float scale, int window,
                   float softcap, cudaStream_t stream) {
  const int G = NH / KV;
  const size_t smem = sizeof(float) * smem_floats(G, hd);
  auto kern = decode_kernel<TQ, TKV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(KV, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<TQ*>(o), S, NH, G, hd, pos,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], scale, window,
      softcap);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch_kv(int kv_dtype, const void* q, const void* k,
                        const void* v, void* o, int B, int S, int NH, int KV,
                        int hd, int pos, const long long* st, float scale,
                        int window, float softcap, cudaStream_t stream) {
  if (kv_dtype == repro::kFloat32)
    return launch<TQ, float>(q, k, v, o, B, S, NH, KV, hd, pos, st, scale,
                             window, softcap, stream);
  if (kv_dtype == repro::kBFloat16)
    return launch<TQ, __nv_bfloat16>(q, k, v, o, B, S, NH, KV, hd, pos, st,
                                     scale, window, softcap, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// shared memory one block needs, in bytes (the wrapper checks it against
// the card's limit before launching)
long long flash_decode_smem_bytes(int G, int hd) {
  return (long long)(sizeof(float) * smem_floats(G, hd));
}

// q and o: contiguous (B, NH, hd).  k, v: (B, S, KV, hd) with any strides
// (elements), given as (batch, seq, head, head_dim)
int flash_decode(const void* q, const void* k, const void* v, void* o,
                 int q_dtype, int kv_dtype, int B, int S, int NH, int KV,
                 int hd, int pos, long long k_sb, long long k_ss,
                 long long k_sh, long long k_sd, long long v_sb,
                 long long v_ss, long long v_sh, long long v_sd, float scale,
                 int window, float softcap, void* stream) {
  const long long st[8] = {k_sb, k_ss, k_sh, k_sd, v_sb, v_ss, v_sh, v_sd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == repro::kFloat32)
    return dispatch_kv<float>(kv_dtype, q, k, v, o, B, S, NH, KV, hd, pos,
                              st, scale, window, softcap, s);
  if (q_dtype == repro::kBFloat16)
    return dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, o, B, S, NH, KV, hd,
                                      pos, st, scale, window, softcap, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
