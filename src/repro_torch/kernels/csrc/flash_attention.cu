// Online-softmax (flash) attention with GQA, for sm_90a: route simt here,
// route wgmma in flash_wgmma.cuh, and their C entry points.
//
// Replaces repro/kernels/flash_attention.py:flash_attention_pallas (kernel
// _fa_kernel) and the kv broadcast of repro/kernels/ops.py:flash_attention.
// It computes, per (batch, q head h) and query row r at global position
// q_offset + r, softmax(q·kᵀ·d^-½) · v over the keys of kv head h / G, with
// the reference's online-softmax arithmetic: an f32 running max, denominator
// and accumulator per row, masked scores at -1e30, p rounded to v's dtype
// before p·v (a no-op for f32), and a write-back of acc / max(l, 1e-30) in
// q's dtype.  Key columns past Sk are masked too (the reference pads them and
// relies on the causal mask).  The planner (core/dse.py:plan_flash) sends
// head dims 64 and 128 (the models' own) to route wgmma, the tensor cores in
// split-precision bf16, and 16 and 32 (the reduced configs) here.
//
// Route simt: on the TPU the kv axis is a sequential grid axis that carries
// the state in VMEM scratch.  Here one block owns one (batch·q head, 64-row
// q tile) and walks the kv tiles itself, with the state in registers; the
// kv head is read in place for every q head of its group (no broadcast
// copy).  A kv tile wholly above the diagonal is never loaded (the
// reference's causal block skip), and the grid starts the heaviest q tiles
// first.  It is bound by the CUDA cores' f32 rate, 67 TFLOP/s: each of the
// 256 threads computes a 4 x 4 tile of the 64 x 64 score block and a
// 4 x (D/16) tile of the output with FFMA, from K (transposed), V, Q and P
// staged as f32 in shared memory; the row max and sum reduce over the 16
// lanes that share a row with warp shuffles.  It served the qwen2-0.5b
// prefill shape (head dim 64) in 5.6 ms on an H100 80GB HBM3 at 700 W
// (PERF.md), where route wgmma's bound is 0.417 ms; it is compiled for head
// dims 16 and 32 only.
#include "common.cuh"
#ifndef REPRO_CPU_SHIM
#include "flash_wgmma.cuh"
#endif

namespace repro {

constexpr int FA_BQ = 64;  // q rows per block
constexpr int FA_BK = 64;  // kv rows per tile
constexpr int FA_THREADS = 256;
constexpr float FA_NEG = -1e30f;

// Element strides of the (batch, head, seq) axes of q, k, v and out; the
// head dim is contiguous.
struct FaStrides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

// p.astype(v.dtype) before the p·v product
__device__ __forceinline__ float round_like(float p, const float*) { return p; }
#ifndef REPRO_CPU_SHIM
__device__ __forceinline__ float round_like(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(p));
}
#endif

// reductions over the 16 lanes (one half warp) that hold one score row
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr int fa_smem_floats() {
  return FA_BQ * (D + 1) + D * (FA_BK + 1) + FA_BK * D + FA_BQ * (FA_BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int hq, int group,
                           int sq, int sk, FaStrides st, int causal, int q_offset,
                           float scale) {
  static_assert(D % 16 == 0, "head dim is a multiple of 16");
  constexpr int DP = D + 1;       // padded row of qs
  constexpr int KP = FA_BK + 1;   // padded row of kt and ps
  constexpr int DJ = D / 16;      // output columns per thread
  DYN_SMEM(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw);  // [BQ][DP]  the q tile
  float* kt = qs + FA_BQ * DP;                      // [D][KP]   the k tile, transposed
  float* vs = kt + D * KP;                          // [BK][D]   the v tile
  float* ps = vs + FA_BK * D;                       // [BQ][KP]  p of this kv tile

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // score columns tx + 16j, output columns tx + 16jj
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int n_qt = (sq + FA_BQ - 1) / FA_BQ;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x);  // heaviest tiles first
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq, hk = h / group;
  const T* qp = q + b * st.qb + h * st.qh;
  const T* kp = k + b * st.kb + hk * st.kh;
  const T* vp = v + b * st.vb + hk * st.vh;
  T* op = out + b * st.ob + h * st.oh;
  const int r0 = qt * FA_BQ;

  for (int idx = tid; idx < FA_BQ * D; idx += FA_THREADS) {
    const int r = idx / D, c = idx % D;
    qs[r * DP + c] = r0 + r < sq ? widen(qp[(r0 + r) * st.qs + c]) : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.0f;
    for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = 0.0f;
  }

  // kv tiles with a first column at or before this tile's last row
  int n_kt = (sk + FA_BK - 1) / FA_BK;
  if (causal) {
    const int q_last = q_offset + r0 + FA_BQ - 1;
    n_kt = min(n_kt, q_last / FA_BK + 1);
  }
  for (int t = 0; t < n_kt; ++t) {
    const int c0 = t * FA_BK;
    __syncthreads();  // the last tile's kt / vs / ps are read
    for (int idx = tid; idx < FA_BK * D; idx += FA_THREADS) {
      const int c = idx / D, d = idx % D;
      float kv = 0.0f, vv = 0.0f;
      if (c0 + c < sk) {
        kv = widen(kp[(c0 + c) * st.ks + d]);
        vv = widen(vp[(c0 + c) * st.vs + d]);
      }
      kt[d * KP + c] = kv;
      vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[4][4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * DP + d];
      for (int j = 0; j < 4; ++j) kk[j] = kt[d * KP + tx + 16 * j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

    for (int i = 0; i < 4; ++i) {
      const int row = q_offset + r0 + ty * 4 + i;
      float mx = FA_NEG;
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool keep = col < sk && (!causal || row >= col);
        s[i][j] = keep ? s[i][j] * scale : FA_NEG;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * KP + tx + 16 * j] = round_like(p, vp);
      }
      l[i] = l[i] * alpha + row_sum(sum);
      for (int jj = 0; jj < DJ; ++jj) acc[i][jj] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

    for (int c = 0; c < FA_BK; ++c) {
      float p[4], vv[DJ];
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * KP + c];
      for (int jj = 0; jj < DJ; ++jj) vv[jj] = vs[c * D + tx + 16 * jj];
      for (int i = 0; i < 4; ++i)
        for (int jj = 0; jj < DJ; ++jj) acc[i][jj] = fmaf(p[i], vv[jj], acc[i][jj]);
    }
  }

  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    for (int jj = 0; jj < DJ; ++jj)
      op[r * st.os + tx + 16 * jj] = narrow_f<T>(acc[i][jj] / den);
  }
}

template <typename T, int D>
int launch_flash(const void* q, const void* k, const void* v, void* out, int batch, int hq,
                 int group, int sq, int sk, const FaStrides& st, int causal, int q_offset,
                 float scale, int plan_bk, int plan_smem, cudaStream_t stream) {
  constexpr int smem = fa_smem_floats<D>() * static_cast<int>(sizeof(float));
  if (plan_bk != FA_BK || plan_smem != smem) return REPRO_BAD_ARG;  // the planner's copy
  auto kfn = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kfn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + FA_BQ - 1) / FA_BQ, batch * hq);
  LAUNCH(kfn, grid, dim3(FA_THREADS), smem, stream, static_cast<const T*>(q),
         static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), hq, group,
         sq, sk, st, causal, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_flash_d(int d, const void* q, const void* k, const void* v, void* out, int batch,
                   int hq, int group, int sq, int sk, const FaStrides& st, int causal,
                   int q_offset, float scale, int bk, int smem, cudaStream_t s) {
  switch (d) {
    case 16: return launch_flash<T, 16>(q, k, v, out, batch, hq, group, sq, sk, st, causal, q_offset, scale, bk, smem, s);
    case 32: return launch_flash<T, 32>(q, k, v, out, batch, hq, group, sq, sk, st, causal, q_offset, scale, bk, smem, s);
    default: return REPRO_BAD_ARG;
  }
}

}  // namespace repro

// q: (B, Hq, Sq, D), k / v: (B, Hkv, Sk, D), out like q, each with the
// element strides of its first three axes in ``strides`` (q, k, v, out in
// turn) and a contiguous last axis.  dtype: 0 = float32, 1 = bfloat16.
// bk and smem are the plan's kv tile and shared memory (core/dse.py:
// plan_flash); a plan that differs from the compiled kernel is refused.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int hq, int hkv, int sq, int sk, int d,
                                      int dtype, const long long* strides, int causal,
                                      int q_offset, float scale, int bk, int smem, int device,
                                      void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || sk <= 0 || hq % hkv != 0 ||
      q_offset < 0 || static_cast<long long>(batch) * hq > 65535)
    return REPRO_BAD_ARG;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const repro::FaStrides st{strides[0], strides[1], strides[2],  strides[3],
                            strides[4], strides[5], strides[6],  strides[7],
                            strides[8], strides[9], strides[10], strides[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = hq / hkv;
  if (dtype == 0)
    return repro::launch_flash_d<float>(d, q, k, v, out, batch, hq, group, sq, sk, st, causal,
                                        q_offset, scale, bk, smem, s);
#ifndef REPRO_CPU_SHIM
  if (dtype == 1)
    return repro::launch_flash_d<__nv_bfloat16>(d, q, k, v, out, batch, hq, group, sq, sk, st,
                                                causal, q_offset, scale, bk, smem, s);
#endif
  return REPRO_BAD_ARG;
}

// Route wgmma's preparation pass (flash_wgmma.cuh): q, k, v as for
// flash_attention_launch, with the strides of their first three axes in
// ``strides`` (q, k, v in turn), into the dense bf16 planes qp, kp, vp.
extern "C" int flash_attention_prep_launch(const void* q, const void* k, const void* v,
                                           void* qp, void* kp, void* vp, int batch, int hq,
                                           int hkv, int sq, int sk, int d, int dtype,
                                           const long long* strides, int device,
                                           void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || sk <= 0 || hq % hkv != 0)
    return REPRO_BAD_ARG;
#ifdef REPRO_CPU_SHIM
  (void)q, (void)k, (void)v, (void)qp, (void)kp, (void)vp, (void)d, (void)dtype;
  (void)strides, (void)device, (void)stream;
  return REPRO_BAD_ARG;  // inline PTX for sm_90a: no CPU counterpart
#else
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return repro::launch_flash_prep(q, k, v, qp, kp, vp, batch, hq, hkv, sq, sk, d, dtype,
                                  strides, static_cast<cudaStream_t>(stream));
#endif
}

// Route wgmma on the planes of flash_attention_prep_launch; out, bk and
// smem as for flash_attention_launch, out's strides in ``out_strides``.
extern "C" int flash_attention_wgmma_launch(const void* qp, const void* kp, const void* vp,
                                            void* out, int batch, int hq, int hkv, int sq,
                                            int sk, int d, int dtype,
                                            const long long* out_strides, int causal,
                                            int q_offset, float scale, int bk, int smem,
                                            int device, void* stream) {
  if (batch <= 0 || hq <= 0 || hkv <= 0 || sq <= 0 || sk <= 0 || hq % hkv != 0 ||
      q_offset < 0)
    return REPRO_BAD_ARG;
#ifdef REPRO_CPU_SHIM
  (void)qp, (void)kp, (void)vp, (void)out, (void)d, (void)dtype, (void)out_strides;
  (void)causal, (void)scale, (void)bk, (void)smem, (void)device, (void)stream;
  return REPRO_BAD_ARG;  // inline PTX for sm_90a: no CPU counterpart
#else
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return repro::launch_flash_wgmma(qp, kp, vp, out, batch, hq, hkv, sq, sk, d, dtype,
                                   out_strides, causal, q_offset, scale, bk, smem,
                                   static_cast<cudaStream_t>(stream));
#endif
}
