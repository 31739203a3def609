// K6 and K7: S=1 decode attention over a paged KV pool (head_dim 128, G = 4
// query heads per KV head), each batch row walking its own block table.
//
// Replaces the Pallas kernels of llama_nuts_and_bolts_tpu/kernels/paged_attention.py:
//   * K6, paged_flash_decode(fold_heads=True) -> _paged_kernel_heads, over a
//     stacked pool [L * n_blocks, KV, bs, D] read at flat block index
//     layer * n_blocks + table[b, m]:
//       - bf16 pool (paged_decode_kernel): the online softmax updates once per
//         span of `chunk` consecutive table entries (chunk * bs keys, 512 at
//         bs = 32), as the Pallas kernel concatenates them into one tile;
//       - int8 pool with bf16 scales (paged_decode_int8_kernel): q quantized
//         per row, int8 x int8 -> int32 score dots with the k scales folded
//         in, and one update per (head, bs-key block) with p folded with the
//         v scales and quantized over that block (kernels/quant_attn_math.py).
//   * K7, paged_flash_decode(fold_heads=False) -> _paged_kernel: bf16 only,
//     single-layer pool, one update per bs-key block: paged_decode_kernel
//     with chunk = 1 and layer = 0.
// Batch row b attends the pool slots holding positions t <= positions[b]:
// the blocks table[b, 0 .. positions[b] / bs]; blocks past the row's position
// are never read (the Pallas index maps clamp them to the last used block,
// whose keys are then masked, so they add nothing). Masked scores at -1e30, l
// floored at 1e-30, p rounded to bf16 before the PV product (bf16 pools).
//
// What bounds it on the H100: bytes. Each visible pool row of k and v is read
// once: sum_b ceil((pos_b + 1) / bs) * bs * KV * D * 2 bytes each for bf16 (1
// byte plus 2 bytes of scale per row and head for int8) against 4 * H * D
// operations per key, one or two per byte -- far below the ~295 FLOP/byte
// ridge.
//
// What the design does about it: the TPU kernel's sequential grid over table
// entries (with the table and positions as prefetched scalars) becomes a loop
// inside one block of 128 threads per (KV head, batch row), which reads its
// own table row and position. Folding the KV heads into one program only
// amortised TPU grid steps, so here each block serves one KV head. Blocks
// are scattered in the pool, so a block's bs x 128 tile is staged in shared
// memory with 16-byte loads; the scores of a whole span stay in shared
// memory for its softmax update. Known limit: at B = 1 the grid is KV = 8
// blocks on 132 SMs (K2's split key walk is the fix).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;           // head_dim
constexpr int G = 4;             // query heads per KV head: Llama-3.1-8B's 32 / 8
constexpr int THREADS = 128;     // one output column d per thread and head
constexpr int WARPS = THREADS / 32;
constexpr int MAX_BS = 64;       // block sizes the kernels take (the pool's is 32)
constexpr int MAX_SPAN = 512;    // keys per softmax update: chunk * bs <= 512
constexpr int KPAD = D + 2;      // shared row stride in bf16: conflict-free columns
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ int clip127(float x) {
  return (int)fminf(fmaxf(rintf(x), -127.f), 127.f);
}

// The last table entry a row reads, or -1 for a row with nothing visible.
__device__ __forceinline__ int last_used(int pos, int bs, int M) {
  return pos < 0 ? -1 : min(pos / bs, M - 1);
}

// Copy one pool block's [bs, D] bf16 rows into shared memory (16-byte loads).
__device__ __forceinline__ void stage_block(const __nv_bfloat16* __restrict__ src,
                                            __nv_bfloat16 (*dst)[KPAD], int bs) {
  for (int idx = threadIdx.x; idx < bs * (D / 8); idx += THREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    uint32_t* d32 = reinterpret_cast<uint32_t*>(&dst[r][c]);
    d32[0] = val.x; d32[1] = val.y; d32[2] = val.z; d32[3] = val.w;
  }
}

__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,      // [B, 1, H, D]
                    const __nv_bfloat16* __restrict__ pool_k, // [L * n_blocks, KV, bs, D]
                    const __nv_bfloat16* __restrict__ pool_v,
                    const int* __restrict__ tables,           // [B, M]
                    const int* __restrict__ positions,        // [B]
                    __nv_bfloat16* __restrict__ out,          // [B, 1, H, D]
                    int H, int KV, int M, int n_blocks, int bs, int chunk,
                    int layer, float scale) {
  __shared__ float qs[G][D];
  __shared__ __align__(16) __nv_bfloat16 tile[MAX_BS][KPAD];
  __shared__ float ps[G][MAX_SPAN];                 // scores, then bf16-rounded p
  __shared__ float m_s[G], l_s[G], corr_s[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = positions[b];
  const int used = last_used(pos, bs, M);
  const int* table = tables + (size_t)b * M;

  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i / D][i % D] = __bfloat162float(qh[i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  const size_t block_elems = (size_t)KV * bs * D;     // one pool block, all heads
  const size_t head_off = (size_t)kvh * bs * D;
  const size_t layer_base = (size_t)layer * n_blocks;

  for (int s0 = 0; s0 <= used; s0 += chunk) {
    const int nblk = min(chunk, used - s0 + 1);      // blocks of the span in use
    const int n_span = nblk * bs;

    // scores of the span: one (head, key) pair per thread and step
    for (int j = 0; j < nblk; ++j) {
      const size_t blk = layer_base + table[s0 + j];
      __syncthreads();                                // the tile's last readers are done
      stage_block(pool_k + blk * block_elems + head_off, tile, bs);
      __syncthreads();
      for (int idx = tid; idx < G * bs; idx += THREADS) {
        const int g = idx / bs, t = idx % bs;
        float sc = NEG_INF;
        if ((s0 + j) * bs + t <= pos) {
          float dot = 0.f;
          const __nv_bfloat162* krow = reinterpret_cast<const __nv_bfloat162*>(&tile[t][0]);
#pragma unroll 8
          for (int d2 = 0; d2 < D / 2; ++d2) {
            const float2 kf = __bfloat1622float2(krow[d2]);
            dot = fmaf(qs[g][2 * d2], kf.x, dot);
            dot = fmaf(qs[g][2 * d2 + 1], kf.y, dot);
          }
          sc = dot * scale;
        }
        ps[g][j * bs + t] = sc;
      }
    }
    __syncthreads();

    // one online-softmax update over the span: warp g owns head row g
    for (int g = warp; g < G; g += WARPS) {
      float mx = NEG_INF;
      for (int i = lane; i < n_span; i += 32) mx = fmaxf(mx, ps[g][i]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int i = lane; i < n_span; i += 32) {
        const float p = expf(ps[g][i] - m_new);
        sum += p;
        ps[g][i] = __bfloat162float(__float2bfloat16(p));   // PV takes p in bf16
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] *= corr_s[g];
    // PV: thread tid owns column d = tid of every head row
    for (int j = 0; j < nblk; ++j) {
      const size_t blk = layer_base + table[s0 + j];
      __syncthreads();
      stage_block(pool_v + blk * block_elems + head_off, tile, bs);
      __syncthreads();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float a = acc[g];
        for (int t = 0; t < bs; ++t)
          a = fmaf(ps[g][j * bs + t], __bfloat162float(tile[t][tid]), a);
        acc[g] = a;
      }
    }
  }
  __syncthreads();

  __nv_bfloat16* oh = out + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g)
    oh[g * D + tid] = __float2bfloat16(acc[g] / fmaxf(l_s[g], 1e-30f));
}

__global__ void __launch_bounds__(THREADS)
paged_decode_int8_kernel(const __nv_bfloat16* __restrict__ q,        // [B, 1, H, D]
                         const int8_t* __restrict__ pool_k,          // [L * n_blocks, KV, bs, D]
                         const int8_t* __restrict__ pool_v,
                         const __nv_bfloat16* __restrict__ pool_ks,  // [L * n_blocks, KV, bs]
                         const __nv_bfloat16* __restrict__ pool_vs,
                         const int* __restrict__ tables,             // [B, M]
                         const int* __restrict__ positions,          // [B]
                         __nv_bfloat16* __restrict__ out,            // [B, 1, H, D]
                         int H, int KV, int M, int n_blocks, int bs, int layer,
                         float scale) {
  __shared__ __align__(16) int q_w[G][D / 4];        // q_i, 4 per word
  __shared__ __align__(16) int8_t vtile[MAX_BS][D];
  __shared__ float s_f[G][MAX_BS];                   // scores, then p * v scale
  __shared__ int8_t p_i[G][MAX_BS];
  __shared__ float qsc_s[G], m_s[G], l_s[G], corr_s[G], ps_s[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = positions[b];
  const int used = last_used(pos, bs, M);
  const int* table = tables + (size_t)b * M;

  // quantize the G query rows (max(|q|, 1e-8) / 127, half to even): warp g
  // owns row g, 4 columns per lane
  {
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
    const float qsc = fmaxf(amax, 1e-8f) / 127.0f;
    uint32_t packed = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      packed |= (uint32_t)(clip127(x[i] / qsc) & 0xFF) << (8 * i);
    q_w[warp][lane] = (int)packed;
    if (lane == 0) {
      qsc_s[warp] = qsc * scale;
      m_s[warp] = NEG_INF;
      l_s[warp] = 0.f;
    }
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  const size_t block_elems = (size_t)KV * bs * D;
  const size_t head_off = (size_t)kvh * bs * D;
  const size_t layer_base = (size_t)layer * n_blocks;
  __syncthreads();

  for (int j = 0; j <= used; ++j) {
    const size_t blk = layer_base + table[j];
    const int8_t* kb = pool_k + blk * block_elems + head_off;
    const int8_t* vb = pool_v + blk * block_elems + head_off;
    const __nv_bfloat16* ksb = pool_ks + (blk * KV + kvh) * bs;
    const __nv_bfloat16* vsb = pool_vs + (blk * KV + kvh) * bs;

    // scores: one (head, key) pair per thread and step, 32 __dp4a over the
    // key's 128-byte row; keys past the row's position at -1e30
    for (int idx = tid; idx < G * bs; idx += THREADS) {
      const int g = idx / bs, t = idx % bs;
      float sc = NEG_INF;
      if (j * bs + t <= pos) {
        const int4* kr = reinterpret_cast<const int4*>(kb + (size_t)t * D);
        const int4* qr = reinterpret_cast<const int4*>(q_w[g]);
        int dot = 0;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) {
          const int4 kw = kr[c], qw = qr[c];
          dot = __dp4a(kw.x, qw.x, dot);
          dot = __dp4a(kw.y, qw.y, dot);
          dot = __dp4a(kw.z, qw.z, dot);
          dot = __dp4a(kw.w, qw.w, dot);
        }
        sc = __fmul_rn(__fmul_rn((float)dot, qsc_s[g]), __bfloat162float(ksb[t]));
      }
      s_f[g][t] = sc;
    }
    for (int idx = tid; idx < bs * (D / 16); idx += THREADS) {
      const int r = idx / (D / 16), c = (idx % (D / 16)) * 16;
      *reinterpret_cast<int4*>(&vtile[r][c]) =
          *reinterpret_cast<const int4*>(vb + (size_t)r * D + c);
    }
    __syncthreads();

    // the block's softmax update and p's quantization over the block: warp g
    // owns row g; p is 0 past the row's position, so pf is too
    {
      const int g = warp;
      float mx = NEG_INF;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, s_f[g][t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f, pmax = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float p = expf(s_f[g][t] - m_new);
        sum += p;
        const float pf = __fmul_rn(p, __bfloat162float(vsb[t]));
        s_f[g][t] = pf;
        pmax = fmaxf(pmax, fabsf(pf));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
        pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
      }
      const float psc = fmaxf(pmax, 1e-30f) / 127.0f;
      for (int t = lane; t < bs; t += 32) p_i[g][t] = (int8_t)clip127(s_f[g][t] / psc);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = __fadd_rn(__fmul_rn(l_s[g], corr), sum);
        m_s[g] = m_new;
        ps_s[g] = psc;
      }
    }
    __syncthreads();

    // PV: thread tid owns column d = tid; exact int32 dots over the block
#pragma unroll
    for (int g = 0; g < G; ++g) {
      int tot = 0;
      for (int t = 0; t < bs; ++t) tot += (int)p_i[g][t] * (int)vtile[t][tid];
      acc[g] = __fadd_rn(__fmul_rn(acc[g], corr_s[g]), __fmul_rn((float)tot, ps_s[g]));
    }
    __syncthreads();                                  // s_f, p_i, vtile reused next block
  }

  __nv_bfloat16* oh = out + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g)
    oh[g * D + tid] = __float2bfloat16(acc[g] / fmaxf(l_s[g], 1e-30f));
}

bool bad_shape(int B, int H, int KV, int M, int bs) {
  return H != KV * G || B < 1 || M < 1 || bs < 1 || bs > MAX_BS;
}

}  // namespace

// Each returns a cudaError_t (0 = launched). Shapes, types and devices are
// checked by the Python wrapper (kernels/paged_attention.py).
extern "C" int lnb_paged_decode(const void* q, const void* pool_k, const void* pool_v,
                                const void* tables, const void* positions, void* out,
                                int B, int H, int KV, int M, int n_blocks, int bs,
                                int chunk, int layer, float scale, void* stream) {
  if (bad_shape(B, H, KV, M, bs) || chunk < 1 || chunk * bs > MAX_SPAN)
    return (int)cudaErrorInvalidValue;
  dim3 grid(KV, B);
  paged_decode_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool_k),
      static_cast<const __nv_bfloat16*>(pool_v), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out), H, KV, M,
      n_blocks, bs, chunk, layer, scale);
  return (int)cudaGetLastError();
}

extern "C" int lnb_paged_decode_int8(const void* q, const void* pool_k, const void* pool_v,
                                     const void* pool_ks, const void* pool_vs,
                                     const void* tables, const void* positions, void* out,
                                     int B, int H, int KV, int M, int n_blocks, int bs,
                                     int layer, float scale, void* stream) {
  if (bad_shape(B, H, KV, M, bs)) return (int)cudaErrorInvalidValue;
  dim3 grid(KV, B);
  paged_decode_int8_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(pool_k),
      static_cast<const int8_t*>(pool_v), static_cast<const __nv_bfloat16*>(pool_ks),
      static_cast<const __nv_bfloat16*>(pool_vs), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out), H, KV, M,
      n_blocks, bs, layer, scale);
  return (int)cudaGetLastError();
}
