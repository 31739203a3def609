// K4, int8_mxu mode: S=1 decode attention over a stacked int8 KV cache with
// int8 x int8 -> int32 dots (head_dim 128, G = 4 query heads per KV head).
//
// Replaces the Pallas kernel llama_nuts_and_bolts_tpu/kernels/decode_attention.py
// (flash_decode_attention, blocked=True, fold_heads=True, int8_mxu=True ->
// _decode_kernel_blocked_heads with kernels/quant_attn_math.py). Per tile of
// block_k cache positions, for the G rows of one KV head:
//   s[g,t]  = float(q_i[g] . k_i[t]) * (qs[g] * softmax_scale) * ks[t], masked
//             to -1e30 past the row's position;
//   m, p = exp(s - m_new), l += sum p   (online fp32 softmax);
//   pf = p * vs[t]; ps = max(max_t |pf|, 1e-30) / 127 over the WHOLE tile;
//   p_i = clip(rint(pf / ps), -127, 127);
//   acc = acc * corr + float(p_i . v_i[:, d]) * ps.
// q is quantized once per row (max(|q|, 1e-8) / 127, half to even). The
// quantization of p runs over the whole tile, so the tile is the JAX kernel's
// (kernels/decode_attention.py::decode_block_k: 2048 for an int8 cache at
// KV = 8, D = 128, T >= 2048); the loads may stream in smaller pieces, the
// quantization row may not shrink.
//
// What bounds it on the H100: bytes. Each visible int8 cache row is read
// once, with 4 bytes of scales per position and head: 2 * KV * (pos + 1) *
// (D + 2) bytes per call against 4 * H * D * (pos + 1) integer operations,
// about one operation per byte.
//
// What the design does about it: folding the KV heads into one program only
// amortised TPU grid steps, so here one block of 8 warps serves one (KV head,
// batch row) with the tile loop inside, as K2 does. Per tile the G x block_k
// fp32 scores stay in shared memory (32 KB at 2048: dynamic shared memory),
// so p is quantized over the whole tile without a second pass over the cache.
// Scores: a thread per key reads its 128-byte k row once and runs 32 __dp4a
// per query row against the quantized q in shared memory. PV: a warp per key
// slice, a lane per 4 columns; 4 rows of v are transposed in registers
// (__byte_perm) so each __dp4a multiplies 4 positions of p_i by 4 of v; the 8
// slices' int32 partials are summed exactly in shared memory. Integer dots
// are exact, so the order of their sums does not matter. Known limit: at
// B=1 the grid is KV = 8 blocks on 132 SMs (K2's split key walk is the fix).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head_dim
constexpr int G = 4;            // query heads per KV head: Llama-3.1-8B's 32 / 8
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLICES = WARPS;   // key slices of the PV product, one per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ int clip127(float x) {
  return (int)fminf(fmaxf(rintf(x), -127.f), 127.f);
}

__global__ void __launch_bounds__(THREADS)
int8_dot_decode_kernel(const __nv_bfloat16* __restrict__ q,        // [B, 1, H, D]
                       const int8_t* __restrict__ k,               // [L, B, KV, T, D]
                       const int8_t* __restrict__ v,
                       const __nv_bfloat16* __restrict__ k_scale,  // [L, B, KV, T]
                       const __nv_bfloat16* __restrict__ v_scale,
                       const int* __restrict__ start_pos,          // [B]
                       __nv_bfloat16* __restrict__ out,            // [B, 1, H, D]
                       int B, int H, int KV, int T, int layer, int block_k,
                       float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bk_pad = (block_k + 15) & ~15;
  float* s_f = reinterpret_cast<float*>(smem);                      // [G][bk_pad]
  int8_t* p_i = reinterpret_cast<int8_t*>(s_f + G * bk_pad);        // [G][bk_pad]
  int* pv_part = reinterpret_cast<int*>(p_i + G * bk_pad);          // [SLICES][G][D]
  __shared__ __align__(16) int q_w[G][D / 4];                       // q_i, 4 per word
  __shared__ float qsc_s[G], m_s[G], l_s[G], corr_s[G], ps_s[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = start_pos[b];
  const int n_keys = min(pos + 1, T);
  const int n_tiles = (n_keys + block_k - 1) / block_k;

  // quantize the G query rows: warp g owns row g, 4 columns per lane
  if (warp < G) {
    const __nv_bfloat16* qrow = q + ((size_t)b * H + (size_t)kvh * G + warp) * D;
    float x[4], amax = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = __bfloat162float(qrow[4 * lane + i]);
      amax = fmaxf(amax, fabsf(x[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float qs = fmaxf(amax, 1e-8f) / 127.0f;
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      packed |= (uint32_t)(clip127(x[i] / qs) & 0xFF) << (8 * i);
    q_w[warp][lane] = (int)packed;
    if (lane == 0) {
      qsc_s[warp] = qs * scale;
      m_s[warp] = NEG_INF;
      l_s[warp] = 0.f;
    }
  }
  float acc[2] = {0.f, 0.f};   // outputs tid and tid + THREADS of the G x D block

  const size_t head = ((size_t)layer * B + b) * KV + kvh;
  const int8_t* kh = k + head * (size_t)T * D;
  const int8_t* vh = v + head * (size_t)T * D;
  const __nv_bfloat16* ksh = k_scale + head * T;
  const __nv_bfloat16* vsh = v_scale + head * T;
  __syncthreads();

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * block_k;
    const int nv = min(block_k, n_keys - t0);          // visible keys of the tile

    // scores, a thread per key; positions past the row (and the padding) at -1e30
    for (int j = tid; j < bk_pad; j += THREADS) {
      if (j < nv) {
        const int4* kr = reinterpret_cast<const int4*>(kh + (size_t)(t0 + j) * D);
        int dot[G] = {0, 0, 0, 0};
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const int4 kw = kr[c];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const int4 qw = reinterpret_cast<const int4*>(q_w[g])[c];
            dot[g] = __dp4a(kw.x, qw.x, dot[g]);
            dot[g] = __dp4a(kw.y, qw.y, dot[g]);
            dot[g] = __dp4a(kw.z, qw.z, dot[g]);
            dot[g] = __dp4a(kw.w, qw.w, dot[g]);
          }
        }
        const float ks = __bfloat162float(ksh[t0 + j]);
#pragma unroll
        for (int g = 0; g < G; ++g)
          s_f[g * bk_pad + j] = __fmul_rn(__fmul_rn((float)dot[g], qsc_s[g]), ks);
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) s_f[g * bk_pad + j] = NEG_INF;
      }
    }
    __syncthreads();

    // softmax and the quantization of p over the whole tile: warp g owns row g
    if (warp < G) {
      float* srow = s_f + warp * bk_pad;
      int8_t* prow = p_i + warp * bk_pad;
      float mx = NEG_INF;
      for (int j = lane; j < bk_pad; j += 32) mx = fmaxf(mx, srow[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[warp];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f, pmax = 0.f;
      for (int j = lane; j < bk_pad; j += 32) {
        const float p = expf(srow[j] - m_new);
        sum += p;
        // p is 0 past the row's position, so its v scale is never needed there
        const float pf = j < nv ? __fmul_rn(p, __bfloat162float(vsh[t0 + j])) : 0.f;
        srow[j] = pf;
        pmax = fmaxf(pmax, fabsf(pf));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
      }
      const float ps = fmaxf(pmax, 1e-30f) / 127.0f;
      for (int j = lane; j < bk_pad; j += 32) prow[j] = (int8_t)clip127(srow[j] / ps);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[warp] = corr;
        l_s[warp] = __fadd_rn(__fmul_rn(l_s[warp], corr), sum);
        m_s[warp] = m_new;
        ps_s[warp] = ps;
      }
    }
    __syncthreads();

    // PV: warp = key slice, lane = columns 4*lane .. 4*lane+3
    {
      int pacc[G][4];
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < 4; ++j) pacc[g][j] = 0;
      const int chunks = (nv + 3) / 4;                   // 4 positions per __dp4a
      for (int ch = warp; ch < chunks; ch += SLICES) {
        const int j0 = 4 * ch;
        int w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = j0 + i < nv
                     ? *reinterpret_cast<const int*>(vh + (size_t)(t0 + j0 + i) * D + 4 * lane)
                     : 0;
        // w[i] holds v[j0+i][4*lane .. +3]; x[c] gets v[j0 .. j0+3][4*lane + c]
        const int lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
        const int lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
        const int x[4] = {(int)__byte_perm(lo01, lo23, 0x5410),
                          (int)__byte_perm(lo01, lo23, 0x7632),
                          (int)__byte_perm(hi01, hi23, 0x5410),
                          (int)__byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int pw = *reinterpret_cast<const int*>(p_i + g * bk_pad + j0);
#pragma unroll
          for (int c = 0; c < 4; ++c) pacc[g][c] = __dp4a(pw, x[c], pacc[g][c]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) pv_part[(warp * G + g) * D + 4 * lane + c] = pacc[g][c];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = tid + i * THREADS, g = o / D;
      int tot = 0;
#pragma unroll
      for (int s = 0; s < SLICES; ++s) tot += pv_part[s * G * D + o];
      acc[i] = __fadd_rn(__fmul_rn(acc[i], corr_s[g]), __fmul_rn((float)tot, ps_s[g]));
    }
    // the next tile writes s_f only; p_i, pv_part and the row state change
    // after the barrier that follows its scores
  }

  __nv_bfloat16* oh = out + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = tid + i * THREADS;
    oh[o] = __float2bfloat16(acc[i] / fmaxf(l_s[o / D], 1e-30f));
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Shapes are checked by the Python
// wrapper; H / KV must be G and T a multiple of block_k.
extern "C" int lnb_flash_decode_int8_mxu(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* start_pos, void* out, int B,
                                         int H, int KV, int T, int layer, int block_k,
                                         float scale, void* stream) {
  if (H != KV * G || block_k < 1 || T % block_k) return (int)cudaErrorInvalidValue;
  const int bk_pad = (block_k + 15) & ~15;
  const size_t smem = (size_t)G * bk_pad * (sizeof(float) + 1) +
                      (size_t)SLICES * G * D * sizeof(int);
  // the limit is raised only when a launch needs more than any before it,
  // so a decode step pays no driver call (one card per process)
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_dot_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  dim3 grid(KV, B);
  int8_dot_decode_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(start_pos),
      static_cast<__nv_bfloat16*>(out), B, H, KV, T, layer, block_k, scale);
  return (int)cudaGetLastError();
}
