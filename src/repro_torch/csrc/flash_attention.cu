// Causal GQA flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (_fwd_kernel / flash_attention_fwd).  Same function: the q.k logits are
// scaled in float32, soft-capped (tanh) and then masked (causal, optional
// sliding window) with NEG_INF, keys at or past Sk get -inf, softmax runs
// online with float32 accumulation, and the output is acc / max(l, 1e-30)
// in q's type.  Query head h reads KV head h / G.
//
// One block per (q tile, head, batch) loops over 64-key tiles of K and V
// (the TPU's sequential k grid axis becomes a loop inside the block).
// Tiles that hold no valid key for any row of the q tile (above the causal
// diagonal, below the window) are skipped; a ragged edge (S not a multiple
// of the tile) is zero-filled on load and masked in the kernel.
//
// Bound.  At prefill sizes the work is O(S^2 hd) against O(S hd) bytes,
// so the card's bound is its bf16 tensor-core rate.
//
// bfloat16 (the model's path): the products run on the tensor cores.
//   - 128-row q tiles, eight warps of 16 rows: each K/V tile copied into
//     shared memory serves 128 q rows, half the copy traffic per q row of
//     64-row tiles (most telling at hd=256, where a tile is 32 KB).  A
//     warp skips the work of a K/V tile that its rows mask out entirely,
//     and rows past Sq, so a 64-row prefill costs no more.
//   - S = Q.K^T and O += P.V are mma.sync.m16n8k16 with bf16 operands
//     (ldmatrix from shared memory) and float32 accumulators in
//     registers; P goes from the S accumulators to the second product in
//     registers (rounded to bf16), as in FlashAttention-2.  mma.sync and
//     not wgmma: a wgmma version (a warpgroup per 64 rows, descriptors
//     without swizzle, P from registers, the next tile's Q.K^T
//     overlapping the softmax) agreed with the plain version but ran
//     slower at the long hd=128 shape (ROADMAP B2).
//   - K/V tiles go through a 2-stage ring in shared memory filled by
//     16-byte cp.async: the next tile's load overlaps this tile's math.
//     cp.async and not TMA: TMA needs a tensor-map descriptor encoded on
//     the host per call (cuTensorMapEncodeTiled, -lcuda), which is host
//     work on a path that the host already bounds.
//   - Rows are padded by 16 bytes in shared memory, so ldmatrix reads and
//     cp.async writes are free of bank conflicts at every head_dim.
//   - Softmax is online in float32 registers: row max and row sum go
//     through quad shuffles within the mma fragment layout; exp2 with
//     log2(e) folded into the argument.  Tiles where every (row, key) pair
//     of the warp is valid skip the mask arithmetic.
//   - Blocks take q tiles from the last to the first: under the causal
//     mask the last tiles have the most keys, and the grid's tail then
//     holds the short ones.
// float32: 64-row q tiles, four threads per row; the products stay on the
//   CUDA cores in float32 FMAs (the tensor cores would bring in TF32 and
//   lose the 2e-5 agreement); this is not the model's path.
#include <stdint.h>

#include "common.cuh"

namespace {

using repro::NEG_INF;

// ---------------------------------------------------------------------------
// float32: CUDA-core body
// ---------------------------------------------------------------------------
namespace simt {

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
template <int HD, bool TWO>
__device__ __forceinline__ void load_rows(float* dst_a, const float* src_a,
                                          long long ss_a, int r0, int rmax,
                                          float mul, float* dst_b = nullptr,
                                          const float* src_b = nullptr,
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
      a[u] = in ? src_a[r * ss_a + d] * mul : 0.f;
      if (TWO) b[u] = in ? src_b[r * ss_b + d] : 0.f;
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

template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_fwd_f32_simt(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int Sq,
                int Sk, int G, long long q_sb, long long q_ss, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh,
                long long o_sb, long long o_ss, long long o_sh, float scale,
                int causal, int window, float softcap) {
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
  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

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
    float* orow = o + b * o_sb + qpos * o_ss + h * o_sh;
#pragma unroll
    for (int jd = 0; jd < DPT; ++jd) orow[c0 + jd * TPR] = acc[jd] / denom;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16), cp.async ring
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;       // q rows per block: 16 per warp
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = 32 * WARPS;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Geo {
  static constexpr int LD = HD + 8;      // padded row stride, elements
  static constexpr uint32_t Q_B = 2 * BQ * LD;     // bytes of the q tile
  static constexpr uint32_t TILE_B = 2 * BK * LD;  // bytes of a K or V tile
  // q tile + 2 stages of (K tile, V tile)
  static constexpr size_t SMEM = Q_B + 4 * (size_t)TILE_B;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; with in == false nothing is read and the 16 bytes
// are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) . b (16x8, col); bf16 operands, float32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Issue the copy of rows [r0, r0 + ROWS) of a (rows x HD) operand into a
// padded tile at shared address dst; rows at or past rmax are zero-filled
// and not read.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          long long ss, int r0, int rmax) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
  constexpr int LD = HD + 8;
  constexpr int N = ROWS * CPR;
#pragma unroll
  for (int u = 0; u < (N + THREADS - 1) / THREADS; ++u) {
    const int c = threadIdx.x + u * THREADS;
    if (N % THREADS && c >= N) break;
    const int r = c / CPR, cc = c % CPR;
    const bool in = r0 + r < rmax;
    cp_async16(dst + 2 * (r * LD + cc * 8),
               in ? src + (long long)(r0 + r) * ss + cc * 8 : src, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
fa_fwd_bf16_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int Sq,
                int Sk, int G, long long q_sb, long long q_ss, long long q_sh,
                long long k_sb, long long k_ss, long long k_sh,
                long long v_sb, long long v_ss, long long v_sh,
                long long o_sb, long long o_ss, long long o_sh, float scale,
                int causal, int window, float softcap) {
  using Gm = Geo<HD>;
  constexpr int LD = Gm::LD;
  constexpr int KSTEPS = HD / 16;  // k-steps of S = Q.K^T
  constexpr int NT = HD / 8;       // n-tiles of O
  // Q fragments stay in registers up to HD=128; at HD=256 the 128 output
  // accumulators take the room and Q is read from shared memory per step
  constexpr bool QREG = HD <= 128;
  constexpr uint32_t TILE_B = Gm::TILE_B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t qs_a = smem_u32(smem_raw);  // then K0, V0, K1, V1
  const uint32_t kv_a = qs_a + Gm::Q_B;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the last q tiles attend to the most keys: start them first, so that
  // the grid's tail holds the short ones
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / G;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  // keys that can be valid for some row of this tile
  const int k_hi = causal ? min(Sk, q0 + BQ) : Sk;
  const int k_lo = window ? max(0, q0 - window + 1) : 0;
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  load_tile<HD, BQ>(qs_a, qb, q_ss, q0, Sq);
  if (ntiles > 0) {
    load_tile<HD, BK>(kv_a, kb, k_ss, k_lo, Sk);
    load_tile<HD, BK>(kv_a + TILE_B, vb, v_ss, k_lo, Sk);
  }
  cp_async_commit();

  const int gr = lane >> 2, tq = lane & 3;  // fragment row and quad lane
  const int r_lo = q0 + warp * 16;          // the warp's first q row
  const int qpos0 = r_lo + gr, qpos1 = qpos0 + 8;

  // ldmatrix lane addresses (bytes): Q as the A operand (rows, 16-col
  // block); K as the col-major B operand of S (keys, d); V through
  // ldmatrix.trans as the B operand of O (keys, d)
  const uint32_t a_off = 2 * ((warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  const uint32_t k_off =
      2 * ((((lane >> 4) << 3) + (lane & 7)) * LD + ((lane >> 3) & 1) * 8);
  const uint32_t v_off =
      2 * (((((lane >> 3) & 1) << 3) + (lane & 7)) * LD + (lane >> 4) * 8);

  float oacc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  uint32_t qf[QREG ? KSTEPS : 1][4];

  for (int it = 0; it < ntiles; ++it) {
    const int kt = k_lo + it * BK;
    const uint32_t ks_a = kv_a + 2 * (it & 1) * TILE_B;
    const uint32_t vs_a = ks_a + TILE_B;
    if (it + 1 < ntiles) {  // prefetch the next tile into the other stage
      const uint32_t nk = kv_a + 2 * ((it + 1) & 1) * TILE_B;
      load_tile<HD, BK>(nk, kb, k_ss, kt + BK, Sk);
      load_tile<HD, BK>(nk + TILE_B, vb, v_ss, kt + BK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (QREG && it == 0) {
#pragma unroll
      for (int kk = 0; kk < (QREG ? KSTEPS : 1); ++kk)
        ldsm_x4(qs_a + a_off + kk * 32, qf[kk]);
    }
    // a warp whose rows are past Sq, or whose rows all mask this tile
    // out, has nothing to add: its state is unchanged by such a tile
    if (r_lo < Sq && !(causal && kt > r_lo + 15) &&
        !(window && kt + BK - 1 < r_lo - window + 1)) {

    // S = Q . K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      if (QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[QREG ? kk : 0][e];
      } else {
        ldsm_x4(qs_a + a_off + kk * 32, a);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4(ks_a + k_off + np * 16 * LD * 2 + kk * 32, bf);
        mma_bf16(s[2 * np], a, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], a, bf[2], bf[3]);
      }
    }

    // scale, softcap, mask; fragment (j, e) is row qpos0 (e < 2) or
    // qpos1, key kt + 8j + 2tq + (e & 1)
    const bool full = kt + BK <= Sk && (!causal || kt + BK - 1 <= r_lo) &&
                      (!window || r_lo + 15 - kt < window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = repro::apply_softcap(s[j][e] * scale, softcap);
        if (!full) {
          const int kpos = kt + 8 * j + 2 * tq + (e & 1);
          const int qp = e < 2 ? qpos0 : qpos1;
          bool valid = true;
          if (causal) valid = valid && qp >= kpos;
          if (window) valid = valid && (qp - kpos) < window;
          x = kpos >= Sk ? -INFINITY : (valid ? x : NEG_INF);
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f((m[r] - mx[r]) * LOG2E);
      m[r] = mx[r];
    }
    // probabilities, packed to bf16 pairs at once (the float logits die
    // here, which leaves room for the accumulators at HD=256): pk[j][r]
    // holds row qpos0 (r = 0) or qpos1 of n-tile j
    uint32_t pk[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2f((s[j][e] - mx[e >> 1]) * LOG2E);
        rs[e >> 1] += p[e];
      }
      pk[j][0] = pack_bf16(p[0], p[1]);
      pk[j][1] = pack_bf16(p[2], p[3]);
    }
    // the row sum stays per lane until the end: alpha is the same for
    // the four lanes of a row
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    // O += P . V: P from the S accumulators (bf16), 16 keys per k-step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pk[2 * kk][0], pk[2 * kk][1], pk[2 * kk + 1][0],
                             pk[2 * kk + 1][1]};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(vs_a + v_off + kk * 16 * LD * 2 + np * 32, bf);
        mma_bf16(oacc[2 * np], a, bf[0], bf[1]);
        mma_bf16(oacc[2 * np + 1], a, bf[2], bf[3]);
      }
    }
    }
    __syncthreads();  // this stage is free for the prefetch after next
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = r ? qpos1 : qpos0;
    if (qp >= Sq) continue;
    bf16* orow = o + b * o_sb + qp * o_ss + h * o_sh + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          oacc[n][2 * r] * inv[r], oacc[n][2 * r + 1] * inv[r]);
  }
}

}  // namespace tc

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int Sq, int Sk, int NH, int KV,
                   const long long* st, float scale, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr size_t smem = F32 ? simt::smem_bytes<HD>() : tc::Geo<HD>::SMEM;
  constexpr int threads = F32 ? simt::THREADS : tc::THREADS;
  constexpr int rows = F32 ? simt::BQ : tc::BQ;  // q rows per block
  auto kern = [] {
    if constexpr (F32) return simt::fa_fwd_f32_simt<HD>;
    else return tc::fa_fwd_bf16_mma<HD>;
  }();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + rows - 1) / rows, NH, B);
  kern<<<grid, threads, smem, stream>>>(
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
// stride is 1 for all four.  For bf16, every row starts 16-byte aligned
// (both checked by the Python wrapper)
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
