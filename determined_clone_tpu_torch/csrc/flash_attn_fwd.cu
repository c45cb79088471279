// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (loaded with ctypes by ops/_build.py).
//
// Replaces the Pallas TPU kernel determined_clone_tpu/ops/flash_attention.py
// :38 (_fwd_kernel, launched by _flash_fwd at :96 through pl.pallas_call at
// :116). Same function: out = softmax(q.k^T * scale + causal mask) . v, with
// the online-softmax state (row max m, denominator l, unnormalised acc) in
// fp32, causal tiles wholly above the diagonal skipped, alpha guarded for
// rows that are fully masked so far, and acc / max(l, 1e-30) written in the
// input dtype. Causal positions start at 0 for queries and keys alike, so
// Tq != Tk is allowed; ragged edges are masked here, so any Tq, Tk work.
//
// Translation. The TPU grid (B*H, Tq/bq, Tk/bk) ran its k axis in order on
// one core and carried m/l/acc in VMEM scratch. Here one CTA of 4 warps owns
// one (batch*head, BQ-row query tile); each warp owns 16*MT consecutive
// query rows and keeps their m/l/acc in registers while the CTA walks the
// K/V tiles. The [B, T, H, D] layout is read through strides (the GPT block
// hands over k and v as views of its fused qkv output); only the head
// dimension must be contiguous, and base pointers and strides must be
// 16-byte aligned for the copies (checked by the wrapper and again here).
//
// Design:
// - K/V stream through a ring of 2 stages in shared memory, 64 keys a tile,
//   brought by 16-byte cp.async (zero-filled past Tk) while the warps
//   compute on the other stage; one barrier per tile. Rows are padded by 16
//   bytes, so the 8 rows an ldmatrix phase (or a warp's 32-bit fragment
//   loads) touches fall in distinct banks for every D in {16, 32, 64, 128}.
//   Q arrives the same way, into the stage its first tile will later fill,
//   and goes to registers once per CTA. At D=64: 36 KB of shared memory in
//   bf16, 68 KB in fp32.
// - bf16 (MT = 2 up to D = 64, so BQ = 128; MT = 1 at D = 128): both
//   products on the tensor cores with mma.sync.m16n8k16 (bf16 operands,
//   fp32 accumulation); each K/V fragment a warp loads feeds its MT tiles.
//   S = Q.K^T comes from the unscaled bf16 operands and is scaled in fp32
//   (1/sqrt(D) is not a power of two for D = 32, 128, so folding it into
//   bf16 q would round q again); log2(e) is folded into exp2. The softmax
//   stays in registers: the 4 lanes sharing a row reduce by two
//   xor-shuffles, only the diagonal and the ragged last tile are masked,
//   and a warp whose rows all precede a causal tile skips it. P stays fp32
//   in registers and is split, P_hi = bf16(P), P_lo = bf16(P - P_hi), and
//   O += P_hi.V + P_lo.V, while l sums the fp32 P. Why: with P rounded to
//   bf16 once, the worst element at the GPT shape misses the per-element
//   gate |out - ref| <= 2^-6 |ref| + 1e-4 by 12.9x (52,457 of 3,145,728
//   elements over); fp16 P by 1.35x (11 over); the hi/lo split uses 0.49x
//   of it (none over). The split costs a second P.V product.
// - fp32 (MT = 1, BQ = 64): 3xTF32 on the tensor cores,
//   mma.sync.m16n8k8.tf32 for both products: hi = cvt.rna.tf32(x),
//   lo = cvt.rna.tf32(x - hi), and a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.
//   One TF32 pass errs by 1.3e-3 at the GPT shape, beyond the 1e-4 gate;
//   the split by 1.7e-6. The S accumulator's layout is used directly as
//   P.V's A operand by permuting the key order of the product (lane t holds
//   keys 2t, 2t+1 of an 8-key step, and reads V's rows 2t, 2t+1 to match).
// - Causal: the q-tile index is reversed, so the longest rows launch first
//   and the short ones fill the tail.
//
// Bound on this card. Bytes: q, k, v read once and o written once,
// 4*B*T*H*D*sizeof(dtype), against 3.35 TB/s of HBM. Operations:
// 4*B*H*pairs*D (pairs: the causal (q, k) pairs) against the tensor-core
// peak. At the GPT width (B=4, T=1024, H=12, D=64, bf16, causal): 7.5 us of
// bytes, 6.5 us of operations at 989 TFLOP/s. What holds this kernel above
// that (PERF.md): every query tile streams its K/V from L2 again, and each
// warp's softmax is a dependent chain that, at 8 warps per SM, the tensor
// work does not hide. wgmma with producer/consumer warpgroups (TMA loads,
// one warpgroup's softmax under the other's products) is the step after
// this one.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;              // keys per K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;           // K/V ring depth
constexpr int NT = BK / 8;          // n8 tiles of S
constexpr float LOG2E = 1.4426950408889634f;

// Padded row-major tile of D-element rows, each row padded by 16 bytes, so
// the 8 rows an ldmatrix phase (or a warp's 32-bit fragment loads) touches
// fall in distinct banks for every D in {16, 32, 64, 128}.
template <typename T, int D>
struct Padded {
  static constexpr int EPC = 16 / sizeof(T);   // elements per 16-byte chunk
  static constexpr int CHUNKS = D / EPC;       // chunks per row
  static constexpr int STRIDE = D + EPC;       // padded row, in elements
  static constexpr int ELEMS = BK * STRIDE;    // one K or V tile
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; with valid == false nothing is read and the
// destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows t0 .. t0+ROWS-1 of one head (row stride `rs` elements) into the
// padded tile `dst`; rows at or past `len` become zeros. Thread c copies
// chunk c % CHUNKS of row c / CHUNKS: a warp reads whole rows.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long rs,
                                          int t0, int len, int tid) {
  using L = Padded<T, D>;
  constexpr int N = ROWS * L::CHUNKS;
  static_assert(N % THREADS == 0, "tile chunks divide among the threads");
#pragma unroll
  for (int i = 0; i < N / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / L::CHUNKS, ch = c % L::CHUNKS;
    const int t = t0 + r;
    const bool ok = t < len;
    cp_async16(dst + r * L::STRIDE + ch * L::EPC,
               src + static_cast<long long>(ok ? t : 0) * rs + ch * L::EPC,
               ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a.b, m16n8k16, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b, m16n8k8, tf32 operands, fp32 accumulator
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a.b in 3xTF32: the small cross terms first, the large one last
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t bhi1,
                                           uint32_t blo0, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One K/V tile's online-softmax step on a warp's S accumulator (m16n8 C
// layout: lane (g = lane/4, t = lane%4) holds rows g and g+8, columns 2t
// and 2t+1 of each n8 tile). m is in units of raw S; l is this lane's
// partial row sum (the 4 lanes of a row are summed at the end). Returns S
// replaced by the fp32 probabilities P.
template <int DT>
__device__ __forceinline__ void online_softmax(
    float (&s)[NT][4], float (&m)[2], float (&l)[2], float (&o)[DT][4],
    float scale_log2, bool mask, int row0, int key0, int Tk, bool causal) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + (e & 1);
        const int row = row0 + (e >> 1) * 8;
        if (key >= Tk || (causal && key > row)) s[j][e] = -INFINITY;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    // fully-masked-so-far rows: no -inf - -inf, and their P is 0
    const float alpha =
        m[h] == -INFINITY ? 0.f : fast_exp2((m[h] - m_new) * scale_log2);
    const float sub = m_new == -INFINITY ? 0.f : m_new * scale_log2;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const float p = fast_exp2(fmaf(s[j][e], scale_log2, -sub));
        s[j][e] = p;
        rs += p;
      }
    l[h] = l[h] * alpha + rs;
    m[h] = m_new;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][2 * h] *= alpha;
      o[d][2 * h + 1] *= alpha;
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int H, Tq, Tk;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh, osb, ost, osh;
  float scale_log2;
  int causal;
};

// Sum the row's 4 partial l, normalise and store rows < Tq.
template <typename T, int D>
__device__ __forceinline__ void store_out(T* ob, long long ost,
                                          float (&o)[D / 8][4],
                                          const float (&l)[2], int row0,
                                          int Tq, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float ls = l[h];
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    const float denom = fmaxf(ls, 1e-30f);
    const int row = row0 + h * 8;
    if (row >= Tq) continue;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      store2(ob + row * ost + d * 8 + 2 * t, o[d][2 * h] / denom,
             o[d][2 * h + 1] / denom);
  }
}

// ---------------------------------------------------------------------------
// The two products, one policy per dtype. A warp owns MT m16 tiles (16*MT
// consecutive query rows); its S (16 x BK) and O (16 x D) accumulators per
// m tile are m16n8 C tiles. Every K/V fragment a warp loads feeds MT tiles.
// ---------------------------------------------------------------------------

// bf16: mma.sync.m16n8k16, Q's A fragments by ldmatrix once, K's B
// fragments by ldmatrix, V's by ldmatrix.trans, and P split into hi + lo.
template <int D_>
struct Bf16Mma {
  using T = __nv_bfloat16;
  // two m tiles up to D = 64; at D = 128 their O alone would fill the
  // registers
  static constexpr int D = D_, MT = D <= 64 ? 2 : 1;
  static constexpr int S = Padded<T, D>::STRIDE;
  uint32_t qf[MT][D / 16][4];

  // lane address inside an x4 ldmatrix: matrix lane/8, row lane%8
  __device__ __forceinline__ void load_q(const T* sQ, int warp, int lane) {
    const int mi = lane / 8, lr = lane % 8;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qf[mt][kk],
                    sQ + ((warp * MT + mt) * 16 + lr + (mi & 1) * 8) * S +
                        kk * 16 + (mi >> 1) * 8);
  }

  __device__ __forceinline__ void qk(float (&s)[MT][NT][4], const T* k_s,
                                     int lane) const {
    const int mi = lane / 8, lr = lane % 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t kf[4];  // b for n tiles n and n+1
        ldmatrix_x4(kf, k_s + (n * 8 + lr + (mi >> 1) * 8) * S + kk * 16 +
                            (mi & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][n], qf[mt][kk], kf[0], kf[1]);
          mma_bf16(s[mt][n + 1], qf[mt][kk], kf[2], kf[3]);
        }
      }
  }

  __device__ __forceinline__ void pv(float (&o)[MT][D / 8][4],
                                     const float (&p)[MT][NT][4],
                                     const T* v_s, int lane) const {
    const int mi = lane / 8, lr = lane % 8;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t phi[MT][4], plo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // A regs: (rows g | g+8) x (keys 2t.. of n tile 2kk | 2kk+1)
          const float* src = &p[mt][2 * kk + (r >> 1)][(r & 1) * 2];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(src[0], src[1]);
          phi[mt][r] = *reinterpret_cast<const uint32_t*>(&hi);
          plo[mt][r] = pack_bf16(src[0] - __low2float(hi),
                                 src[1] - __high2float(hi));
        }
#pragma unroll
      for (int d = 0; d < D / 8; d += 2) {
        uint32_t vf[4];  // b for d tiles d and d+1
        ldmatrix_x4_trans(vf, v_s + (kk * 16 + lr + (mi & 1) * 8) * S +
                                  d * 8 + (mi >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(o[mt][d], plo[mt], vf[0], vf[1]);
          mma_bf16(o[mt][d], phi[mt], vf[0], vf[1]);
          mma_bf16(o[mt][d + 1], plo[mt], vf[2], vf[3]);
          mma_bf16(o[mt][d + 1], phi[mt], vf[2], vf[3]);
        }
      }
    }
  }
};

// fp32: 3xTF32 mma.sync.m16n8k8; Q's fragments stay fp32 in registers and
// every operand is split where it is used. One m tile per warp: the
// splits already take the registers a second would need.
template <int D_>
struct Tf32x3Mma {
  using T = float;
  static constexpr int D = D_, MT = 1;
  static constexpr int S = Padded<T, D>::STRIDE;
  float qf[D / 8][4];

  __device__ __forceinline__ void load_q(const T* sQ, int warp, int lane) {
    const T* qr = sQ + (warp * 16 + lane / 4) * S + lane % 4;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      qf[kk][0] = qr[kk * 8];
      qf[kk][1] = qr[8 * S + kk * 8];
      qf[kk][2] = qr[kk * 8 + 4];
      qf[kk][3] = qr[8 * S + kk * 8 + 4];
    }
  }

  __device__ __forceinline__ void qk(float (&s)[1][NT][4], const T* k_s,
                                     int lane) const {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(qf[kk][r], ahi[r], alo[r]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // b: K[key n*8+g][d kk*8+t], [.. +4]
        const T* kr = k_s + (n * 8 + g) * S + kk * 8 + t;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kr[0], bh0, bl0);
        split_tf32(kr[4], bh1, bl1);
        mma_3xtf32(s[0][n], ahi, alo, bh0, bh1, bl0, bl1);
      }
    }
  }

  // O += P.V over 8-key steps. The product's key order is permuted: lane
  // (g, t) holds P at keys 2t, 2t+1 of the step (S's C layout) and passes
  // them as A columns t and t+4, so B rows t and t+4 are V's rows 2t and
  // 2t+1.
  __device__ __forceinline__ void pv(float (&o)[1][D / 8][4],
                                     const float (&p)[1][NT][4],
                                     const T* v_s, int lane) const {
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ahi[4], alo[4];
      split_tf32(p[0][kk][0], ahi[0], alo[0]);  // (g,   key 2t)
      split_tf32(p[0][kk][2], ahi[1], alo[1]);  // (g+8, key 2t)
      split_tf32(p[0][kk][1], ahi[2], alo[2]);  // (g,   key 2t+1)
      split_tf32(p[0][kk][3], ahi[3], alo[3]);  // (g+8, key 2t+1)
      const T* vr = v_s + (kk * 8 + 2 * t) * S + g;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(vr[d * 8], bh0, bl0);
        split_tf32(vr[S + d * 8], bh1, bl1);
        mma_3xtf32(o[0][d], ahi, alo, bh0, bh1, bl0, bl1);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// The kernel: one CTA per (batch*head, BQ query rows), K/V through the ring
// ---------------------------------------------------------------------------

template <typename M>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const Args a) {
  using T = typename M::T;
  constexpr int D = M::D, MT = M::MT, BQ = 16 * WARPS * MT;
  constexpr int E = Padded<T, D>::ELEMS;  // one K or V tile, in elements
  static_assert(BQ <= 2 * BK, "Q fits in one stage of the ring");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // stage s: K at 2s*E, V at (2s+1)*E; Q in the last stage until its tile
  T* const ring = reinterpret_cast<T*>(smem_raw);
  T* const sQ = ring + 2 * (STAGES - 1) * E;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const bool causal = a.causal != 0;
  const T* qb = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* kb = static_cast<const T*>(a.k) + b * a.ksb + h * a.ksh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vsb + h * a.vsh;
  T* ob = static_cast<T*>(a.o) + b * a.osb + h * a.osh;

  // causal: a tile starting past this query tile's last row is all masked
  const int k_end = causal ? min(a.Tk, q0 + BQ) : a.Tk;
  const int n_tiles = (k_end + BK - 1) / BK;
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      T* st = ring + 2 * (j % STAGES) * E;
      load_tile<T, D, BK>(st, kb, a.kst, j * BK, a.Tk, tid);
      load_tile<T, D, BK>(st + E, vb, a.vst, j * BK, a.Tk, tid);
    }
    cp_async_commit();  // one group per tile, empty past the end
  };

  // group 0: Q and tile 0; then tiles 1 .. STAGES-2
  load_tile<T, D, BQ>(sQ, qb, a.qst, q0, a.Tq, tid);
  load_kv(0);
#pragma unroll
  for (int j = 1; j < STAGES - 1; ++j) load_kv(j);
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  M math;
  math.load_q(sQ, warp, lane);

  float o[MT][D / 8][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][d][e] = 0.f;
  }
  const int row0 = q0 + warp * 16 * MT + g;  // lane's first row
  const int warp_last = q0 + (warp + 1) * 16 * MT - 1;

  for (int j = 0; j < n_tiles; ++j) {
    // tile j has landed, and every warp is done with tile j-1 (and with
    // Q), so its stage takes tile j+STAGES-1 while this one is computed
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_kv(j + STAGES - 1);
    const int k0 = j * BK;
    if (causal && k0 > warp_last) continue;  // every row of this warp masked
    const T* st = ring + 2 * (j % STAGES) * E;

    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
    math.qk(s, st, lane);
    const bool mask = k0 + BK > a.Tk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      online_softmax<D / 8>(s[mt], m[mt], l[mt], o[mt], a.scale_log2, mask,
                            row0 + mt * 16, k0 + 2 * t, a.Tk, causal);
    math.pv(o, s, st + E, lane);
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_out<T, D>(ob, a.ost, o[mt], l[mt], row0 + mt * 16, a.Tq, t);
}

template <typename M>
int run(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem =
      2 * STAGES * Padded<typename M::T, M::D>::ELEMS * sizeof(typename M::T);
  // the shared-memory opt-in, once per kernel and device (not per launch:
  // the call costs host time, and a launch may be under graph capture)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(
        flash_fwd<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  constexpr int BQ = 16 * WARPS * M::MT;
  const dim3 grid(B * a.H, (a.Tq + BQ - 1) / BQ);
  flash_fwd<M><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const Args& a, int B, cudaStream_t stream) {
  if (dtype == 0) return run<Tf32x3Mma<D>>(a, B, stream);
  return run<Bf16Mma<D>>(a, B, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: 12 element strides, the
// (batch, time, head) strides of q, k, v and o in that order; the head
// dimension must be contiguous, and pointers and strides (in bytes) must
// be multiples of 16. scale multiplies q.k (1/sqrt(D)). Returns 0, a
// cudaError_t code from the launch, -1 for an unsupported dtype/head_dim,
// -2 for a misaligned pointer or stride. Allocates nothing and does not
// synchronise.
int flash_attn_fwd(int dtype, int head_dim, const void* q, const void* k,
                   const void* v, void* o, int B, int H, int Tq, int Tk,
                   const long long* strides, float scale, int causal,
                   void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  const long long item = dtype == 0 ? 4 : 2;
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o))
    return -2;
  for (int i = 0; i < 12; ++i)
    if ((strides[i] * item) % 16 != 0) return -2;
  const Args a{q, k, v, o, H, Tq, Tk,
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], strides[6], strides[7], strides[8], strides[9],
               strides[10], strides[11], scale * LOG2E, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(dtype, a, B, st);
    case 32: return launch<32>(dtype, a, B, st);
    case 64: return launch<64>(dtype, a, B, st);
    case 128: return launch<128>(dtype, a, B, st);
    default: return -1;
  }
}

const char* flash_attn_error_string(int code) {
  if (code == -1) return "unsupported dtype or head_dim";
  if (code == -2) return "pointer or stride not a multiple of 16 bytes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
