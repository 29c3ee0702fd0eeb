// Causal GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_fwd_kernel / flash_attention_fwd).  Same function: q is scaled, the
// q.k logit tile is soft-capped (tanh) and then masked (causal, optional
// sliding window) with NEG_INF, softmax runs online with float32
// accumulation, and the output is acc / max(l, 1e-30) in q's type.
// Query head h reads KV head h / G.
//
// Design.  One block of 256 threads per (64-row q tile, head, batch);
// the block loops over 64-key tiles of K and V, so the TPU's sequential
// k grid axis becomes a loop inside the block.  Four threads share a q
// row: each holds 16 of the row's logits and HD/4 of its output columns
// in registers; row max and row sum go through warp shuffles.  Q, K, V
// and P tiles sit in shared memory as float32 with one pad word per row
// (no bank conflicts); each thread keeps a chunk of tile loads in flight
// before storing them.  Tiles that hold no valid key for any row of the
// q tile (above the causal diagonal, below the window) are skipped; a
// ragged edge (S not a multiple of 64) is masked in the kernel.
//
// Bound.  At prefill sizes the work is O(S^2 hd) against O(S hd) bytes,
// so the card's bound is its tensor-core rate.  This first version runs
// the products on the CUDA cores in float32 FMAs (no wgmma / TMA yet),
// so it is compute-bound well above that bound; a wgmma/TMA redesign is
// queued in the ROADMAP.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::NEG_INF;
using repro::from_f;
using repro::to_f;

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // keys per tile
constexpr int TPR = 4;        // threads per q row
constexpr int THREADS = BQ * TPR;

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (HD + 1) + 2 * BK * (HD + 1) +
                                  BQ * (BK + 1));
}

// Stage 64 rows [r0, r0 + 64) of one (TWO=false) or two (rows x HD)
// operands into padded float tiles (rows at or past rmax read as 0; `mul`
// scales the first).  Each thread issues a chunk of loads of every
// operand before it stores any, so many loads are in flight per thread.
template <int HD, bool TWO, typename T>
__device__ __forceinline__ void load_rows(float* dst_a, const T* src_a,
                                          long long ss_a, int r0, int rmax,
                                          float mul, float* dst_b = nullptr,
                                          const T* src_b = nullptr,
                                          long long ss_b = 0) {
  constexpr int N = BQ * HD;
  // 8 loads of each operand in flight; 4 at HD=256, where the output
  // columns already take most of the registers
  constexpr int CH = N / THREADS < 8 ? N / THREADS : (HD > 128 ? 4 : 8);
  for (int c = threadIdx.x; c < N; c += THREADS * CH) {
    float a[CH], b[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int i = c + u * THREADS;
      const int r = r0 + i / HD, d = i % HD;
      const bool in = r < rmax;
      a[u] = in ? to_f(src_a[r * ss_a + d]) * mul : 0.f;
      if (TWO) b[u] = in ? to_f(src_b[r * ss_b + d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int i = c + u * THREADS;
      const int off = (i / HD) * (HD + 1) + i % HD;
      dst_a[off] = a[u];
      if (TWO) dst_b[off] = b[u];
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
           int G, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, long long o_sb, long long o_ss,
           long long o_sh, float scale, int causal, int window,
           float softcap) {
  constexpr int LD = HD + 1;     // padded row stride of the tiles
  constexpr int PLD = BK + 1;
  constexpr int DPT = HD / TPR;  // output columns per thread
  constexpr int CPT = BK / TPR;  // logits per thread per tile
  extern __shared__ float smem[];
  float* qs = smem;              // BQ x LD, pre-scaled q
  float* ks = qs + BQ * LD;      // BK x LD
  float* vs = ks + BK * LD;      // BK x LD
  float* ps = vs + BK * LD;      // BQ x PLD, probabilities of the tile

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  load_rows<HD, false>(qs, qb, q_ss, q0, Sq, scale);

  const int r = tid / TPR;   // this thread's row in the q tile
  const int c0 = tid % TPR;  // its first column; columns step by TPR
  const int qpos = q0 + r;
  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;
  float m = NEG_INF, l = 0.f;

  // keys that can be valid for some row of this tile
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;

  for (int kt = k_lo; kt < k_hi; kt += BK) {
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    load_rows<HD, true>(ks, kb, k_ss, kt, Sk, 1.f, vs, vb, v_ss);
    __syncthreads();

    float s[CPT];
    float m_new = m;
    const float* qr = qs + r * LD;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int j = c0 + jj * TPR;
      const int kpos = kt + j;
      const float* kr = ks + j * LD;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kr[d], dot);
      dot = repro::apply_softcap(dot, softcap);
      bool valid = true;
      if (causal) valid = valid && qpos >= kpos;
      if (window) valid = valid && (qpos - kpos) < window;
      const float val = kpos >= Sk ? -INFINITY : (valid ? dot : NEG_INF);
      s[jj] = val;
      m_new = fmaxf(m_new, val);
    }
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 1));
    m_new = fmaxf(m_new, __shfl_xor_sync(0xffffffffu, m_new, 2));

    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const float p = expf(s[jj] - m_new);
      ps[r * PLD + c0 + jj * TPR] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncthreads();  // the row's probabilities come from all four lanes

    float pv[DPT];
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) pv[jd] = 0.f;
    const float* pr = ps + r * PLD;
    for (int j = 0; j < BK; ++j) {
      const float p = pr[j];
      const float* vr = vs + j * LD + c0;
#pragma unroll
      for (int jd = 0; jd < DPT; ++jd) pv[jd] = fmaf(p, vr[jd * TPR], pv[jd]);
    }
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) acc[jd] = acc[jd] * alpha + pv[jd];
  }

  if (qpos < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    T* orow = o + b * o_sb + qpos * o_ss + h * o_sh;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd)
      orow[c0 + jd * TPR] = from_f<T>(acc[jd] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int NH, int KV,
                   const long long* st, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = fwd_kernel<T, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, NH, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, NH / KV, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* o, int B, int Sq, int Sk, int NH, int KV,
                        const long long* st, float scale, int causal,
                        int window, float softcap, cudaStream_t stream) {
#define REPRO_FA_CASE(HD)                                                  \
  case HD:                                                                 \
    return launch<T, HD>(q, k, v, o, B, Sq, Sk, NH, KV, st, scale, causal, \
                         window, softcap, stream);
  switch (hd) {
    REPRO_FA_CASE(16)
    REPRO_FA_CASE(32)
    REPRO_FA_CASE(64)
    REPRO_FA_CASE(128)
    REPRO_FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FA_CASE
}

}  // namespace

extern "C" {

// strides (elements): q, k, v, o each as (batch, seq, head); the head_dim
// stride is 1 for all four (checked by the Python wrapper)
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int dtype, int B, int Sq, int Sk, int NH, int KV,
                        int hd, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss,
                        long long k_sh, long long v_sb, long long v_ss,
                        long long v_sh, long long o_sb, long long o_ss,
                        long long o_sh, float scale, int causal, int window,
                        float softcap, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_hd<float>(hd, q, k, v, o, B, Sq, Sk, NH, KV, st, scale,
                              causal, window, softcap, s);
  if (dtype == repro::kBFloat16)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Sk, NH, KV, st,
                                      scale, causal, window, softcap, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
