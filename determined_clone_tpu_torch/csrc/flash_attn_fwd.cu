// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ops/_build.py).
//
// Replaces the Pallas TPU kernel determined_clone_tpu/ops/flash_attention.py
// :_fwd_kernel (launched by _flash_fwd through pl.pallas_call). Same
// function: out = softmax(q.k^T / sqrt(D) + causal mask) . v, with the
// online-softmax state (row max m, denominator l, unnormalised acc) in fp32,
// q/k/v converted to fp32 on load exactly as the TPU kernel's astype(f32),
// causal tiles wholly above the diagonal skipped, alpha guarded for rows
// that are fully masked so far, and acc / max(l, 1e-30) written in the
// input dtype. Causal positions start at 0 for queries and keys alike, so
// Tq != Tk is allowed.
//
// Translation. The TPU grid (B*H, Tq/bq, Tk/bk) ran its k axis in order on
// one core and carried m/l/acc in VMEM scratch between grid steps. Here one
// CTA owns one (batch*head, 64-row query tile) and walks the K/V tiles in a
// loop; m/l/acc live in registers of the threads that own the rows. The
// kernel reads the [B, T, H, D] layout through strides (no transpose
// copies; only the last dimension must be contiguous) and masks ragged
// edges itself, so its 64x64 tile is independent of the wrapper's
// block_q/block_k, which keep the JAX contract (clamp, divisibility).
//
// Thread layout (128 threads = 16 row groups x 8 column lanes): thread
// (ty, tx) owns query rows ty*4 .. ty*4+3. For the score tile it computes
// columns tx + 8c (c < 8); the 8 lanes of a row group sit in one warp, so
// row max and row sum are three xor-shuffles. For the output it owns
// columns tx + 8c (c < D/8) of the same rows, so alpha rescales registers
// it already holds. P goes through shared memory between the two products.
//
// Bound on this card. Bytes: q, k, v read once and o written once,
// 4*B*T*H*D*sizeof(dtype), against 3.35 TB/s of HBM. Operations:
// 4*B*H*Tq*Tk*D (halved when causal) against the bf16 tensor-core peak of
// 989 TFLOP/s. At the GPT width (B=4, T=1024, H=12, D=64, bf16, causal) the
// two are 7.5 us and 6.5 us. This first version does its arithmetic on the
// fp32 CUDA cores from shared memory (the TPU kernel's fp32 numerics, and
// the fp32 tolerance of 1e-4 rules out TF32), so it sits far above that
// bound; wgmma/TMA tiles are the later work that closes the gap.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;           // query rows per CTA
constexpr int BK = 64;           // keys per K/V tile
constexpr int TX = 8;            // column lanes per row group
constexpr int TY = 16;           // row groups
constexpr int THREADS = TX * TY;
constexpr int RPT = BQ / TY;     // query rows per thread (4)
constexpr int CPT = BK / TX;     // score columns per thread (8)
constexpr int PS = BK + 1;       // padded P row: conflict-free row reads
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr int smem_floats() {
  // Qs [BQ][D+1], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1]
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * PS;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int H, int Tq,
                 int Tk, long long qsb, long long qst, long long qsh,
                 long long ksb, long long kst, long long ksh, long long vsb,
                 long long vst, long long vsh, long long osb, long long ost,
                 long long osh, float scale, int causal) {
  constexpr int DP = D + 1;      // padded row: conflict-free column reads
  constexpr int DPT = D / TX;    // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * DP;
  float* Vs = Ks + BK * DP;
  float* Ps = Vs + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.y * BQ;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;
  T* ob = o + b * osb + h * osh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    Qs[r * DP + c] = t < Tq ? to_f32(qb[t * qst + c]) * scale : 0.f;
  }

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
  }

  // causal: a tile starting past this query tile's last row is all masked
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      const bool in = t < Tk;
      Ks[r * DP + c] = in ? to_f32(kb[t * kst + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[t * vst + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) qv[r] = Qs[(ty * RPT + r) * DP + d];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[(tx + c * TX) * DP + d];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int qpos = q0 + ty * RPT + r;
      bool ok[CPT];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int kpos = k0 + tx + c * TX;
        ok[c] = kpos < Tk && (!causal || qpos >= kpos);
        if (!ok[c]) s[r][c] = NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      // fully-masked-so-far rows: exp(NEG_INF - NEG_INF) must not be 1
      const float alpha = m[r] > NEG_INF / 2 ? expf(m[r] - m_new) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.f;
        rs += p;
        Ps[(ty * RPT + r) * PS + tx + c * TX] = p;
      }
#pragma unroll
      for (int off = 1; off < TX; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[r][c] *= alpha;
    }
    __syncwarp();  // a row group's P is written and read inside one warp

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RPT], vv[DPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r) pv[r] = Ps[(ty * RPT + r) * PS + j];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = Vs[j * D + tx + c * TX];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int t = q0 + ty * RPT + r;
    if (t >= Tq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPT; ++c)
      store_as(&ob[t * ost + tx + c * TX], acc[r][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Tq, int Tk, const long long* s, float scale,
           int causal, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Tq, Tk, s[0], s[1],
      s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11], scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
               int B, int H, int Tq, int Tk, const long long* s, float scale,
               int causal, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, Tq, Tk, s, scale, causal, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Tq, Tk, s, scale, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Tq, Tk, s, scale, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Tq, Tk, s, scale, causal, stream);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, the
// (batch, time, head) strides of q, k, v and o in that order; the head
// dimension must be contiguous. scale multiplies q (1/sqrt(D)). Returns 0,
// a cudaError_t code from the launch, or -1 for an unsupported
// dtype/head_dim. Allocates nothing and does not synchronise.
int flash_attn_fwd(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, void* o, int B, int H, int Tq, int Tk,
                   const long long* strides, float scale, int causal,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(head_dim, q, k, v, o, B, H, Tq, Tk, strides,
                             scale, causal, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(head_dim, q, k, v, o, B, H, Tq, Tk,
                                     strides, scale, causal, st);
  return -1;
}

const char* flash_attn_error_string(int code) {
  if (code == -1) return "unsupported dtype or head_dim";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
