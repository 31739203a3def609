// K1: causal, cache-bounded GQA flash attention for prefill (bf16, head_dim 128).
//
// Replaces the Pallas kernel llama_nuts_and_bolts_tpu/kernels/attention.py
// (flash_gqa_attention -> _flash_kernel). Query row s sits at start_pos + s
// and sees cache slot t iff t <= start_pos + s. Online fp32 softmax, the G
// query heads of one KV head folded into the row dimension, p rounded to
// bf16 before the PV product, masked scores at -1e30, l floored at 1e-30.
//
// What bounds it on the H100: at prefill widths (S, T in the thousands) the
// QK^T and PV products, i.e. tensor-core operations; the K/V bytes are
// re-read once per q tile but stay small next to the FLOPs.
//
// What the design does about it: one block per (q tile, kv head, batch row)
// owns 128 rows = (128 / G) positions x G heads, so each K/V tile loaded to
// shared memory serves all G heads of the group. Eight warps each own 16 rows
// and run both products on the tensor cores with mma.sync m16n8k16 (bf16 in,
// fp32 accumulate). The S tile stays in registers and is reused as the A
// operand of PV, so scores never touch shared or device memory. Key tiles
// past the last row's position are never loaded. Not yet done (later work):
// cp.async/TMA double buffering, wgmma, ldmatrix.
//
// Launch geometry is mirrored in kernels/attention.py (K1_ROWS, K1_BLOCK_K).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head_dim
constexpr int ROWS = 128;       // query rows per block (positions x G)
constexpr int WARPS = ROWS / 16;
constexpr int THREADS = WARPS * 32;
constexpr int BLOCK_K = 64;     // keys per tile
constexpr int G = 4;            // query heads per KV head: Llama-3.1-8B's 32 / 8
constexpr int KPAD = D + 8;     // shared-memory row stride (bank spread)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
flash_gqa_kernel(const __nv_bfloat16* __restrict__ q,   // [B, S, H, D]
                 const __nv_bfloat16* __restrict__ k,   // [B, KV, T, D]
                 const __nv_bfloat16* __restrict__ v,   // [B, KV, T, D]
                 __nv_bfloat16* __restrict__ out,       // [B, S, H, D]
                 int S, int H, int KV, int T, int start_pos, float scale) {
  constexpr int BQ = ROWS / G;  // positions per block
  __shared__ __align__(16) __nv_bfloat16 ks[BLOCK_K][KPAD];
  __shared__ __align__(16) __nv_bfloat16 vs[BLOCK_K][KPAD];

  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;

  // this thread's two rows (fragment rows gid and gid + 8 of its warp)
  const int ra = warp * 16 + gid, rb = ra + 8;
  const int pos_a = qt * BQ + ra / G, pos_b = qt * BQ + rb / G;
  const int head_a = kvh * G + ra % G, head_b = kvh * G + rb % G;
  const int qpos_a = start_pos + pos_a, qpos_b = start_pos + pos_b;

  const __nv_bfloat16* q_a = q + (((size_t)b * S + pos_a) * H + head_a) * D;
  const __nv_bfloat16* q_b = q + (((size_t)b * S + pos_b) * H + head_b) * D;
  const bool in_a = pos_a < S, in_b = pos_b < S;

  // Q fragments for all 8 k-steps of D, held in registers for the whole loop
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = in_a ? *reinterpret_cast<const uint32_t*>(q_a + c) : 0u;
    qf[kk][1] = in_b ? *reinterpret_cast<const uint32_t*>(q_b + c) : 0u;
    qf[kk][2] = in_a ? *reinterpret_cast<const uint32_t*>(q_a + c + 8) : 0u;
    qf[kk][3] = in_b ? *reinterpret_cast<const uint32_t*>(q_b + c + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  // keys up to the last position any row of this tile may see
  const int kv_end = min(T, start_pos + (qt + 1) * BQ);
  const int n_tiles = (kv_end + BLOCK_K - 1) / BLOCK_K;
  const size_t head_off = ((size_t)b * KV + kvh) * (size_t)T * D;
  const __nv_bfloat16* kh = k + head_off;
  const __nv_bfloat16* vh = v + head_off;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * BLOCK_K;
    __syncthreads();  // the previous tile's reads of ks/vs are done
    for (int idx = tid; idx < BLOCK_K * (D / 8); idx += THREADS) {
      const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      if (t0 + r < T) {
        kval = *reinterpret_cast<const uint4*>(kh + (size_t)(t0 + r) * D + c);
        vval = *reinterpret_cast<const uint4*>(vh + (size_t)(t0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(&ks[r][c]) = kval;
      *reinterpret_cast<uint4*>(&vs[r][c]) = vval;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys)
    float s[BLOCK_K / 8][4];
#pragma unroll
    for (int nt = 0; nt < BLOCK_K / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < BLOCK_K / 8; ++nt) {
        const __nv_bfloat16* krow = &ks[nt * 8 + gid][kk * 16 + tig * 2];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + 8);
        mma16816(s[nt], qf[kk], b0, b1);
      }
    }

    // scale, mask, and the online-softmax update of rows a and b
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < BLOCK_K / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = t0 + nt * 8 + tig * 2 + j;
        s[nt][j] = (t < T && t <= qpos_a) ? s[nt][j] * scale : NEG_INF;
        s[nt][2 + j] = (t < T && t <= qpos_b) ? s[nt][2 + j] * scale : NEG_INF;
        mx_a = fmaxf(mx_a, s[nt][j]);
        mx_b = fmaxf(mx_b, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < BLOCK_K / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn_a);
      s[nt][1] = expf(s[nt][1] - mn_a);
      s[nt][2] = expf(s[nt][2] - mn_b);
      s[nt][3] = expf(s[nt][3] - mn_b);
      sum_a += s[nt][0] + s[nt][1];
      sum_b += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= corr_a;
      acc[dt][1] *= corr_a;
      acc[dt][2] *= corr_b;
      acc[dt][3] *= corr_b;
    }

    // O += bf16(P) V: the S accumulators are the A fragments of PV
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int key = kk * 16 + tig * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const int d = dt * 8 + gid;
        const uint32_t b0 = pack_raw(vs[key][d], vs[key + 1][d]);
        const uint32_t b1 = pack_raw(vs[key + 8][d], vs[key + 9][d]);
        mma16816(acc[dt], pa, b0, b1);
      }
    }
  }

  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* o_a = out + (((size_t)b * S + pos_a) * H + head_a) * D;
  __nv_bfloat16* o_b = out + (((size_t)b * S + pos_b) * H + head_b) * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int c = dt * 8 + tig * 2;
    if (in_a)
      *reinterpret_cast<uint32_t*>(o_a + c) = pack_bf16(acc[dt][0] * inv_a, acc[dt][1] * inv_a);
    if (in_b)
      *reinterpret_cast<uint32_t*>(o_b + c) = pack_bf16(acc[dt][2] * inv_b, acc[dt][3] * inv_b);
  }
}

}  // namespace

// Returns a cudaError_t (0 = launched). Shapes are checked by the Python
// wrapper; H / KV must be G.
extern "C" int lnb_flash_gqa_attention(const void* q, const void* k,
                                       const void* v, void* out, int B, int S,
                                       int H, int KV, int T, int start_pos,
                                       float scale, void* stream) {
  if (H != KV * G) return (int)cudaErrorInvalidValue;
  constexpr int BQ = ROWS / G;
  dim3 grid((S + BQ - 1) / BQ, KV, B);
  flash_gqa_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, H, KV, T, start_pos, scale);
  return (int)cudaGetLastError();
}
