// K2 and K3: S=1 flash decode attention over a stacked KV cache (head_dim 128),
// bf16 (K2) or int8 with per-position bf16 scales (K3).
//
// Replaces the Pallas kernel llama_nuts_and_bolts_tpu/kernels/decode_attention.py
// (flash_decode_attention, blocked=True, fold_heads=False ->
// _decode_kernel_blocked) for a bf16 and an int8 cache. Batch row b attends
// cache slots t <= start_pos[b] of layer `layer` of a [L, B, KV, T, D] cache;
// tiles past a row's position are never read. An int8 element is dequantized
// to bf16(bf16(int8) * bf16(scale[t])) as the tile is loaded, as the Pallas
// kernel does, so both caches reach the products as bf16 tiles. Online fp32
// softmax, the G query heads of one KV head share each K/V tile, p rounded to
// bf16 before the PV product, masked scores at -1e30, l floored at 1e-30.
//
// What bounds it on the H100: bytes. Each visible cache row is read once
// (2 * KV * (pos + 1) * D bytes per call for int8, twice that for bf16, plus
// 4 bytes of scales per position and head for int8) against
// 4 * H * D * (pos + 1) FLOPs, one or two FLOPs per byte -- far below the
// ~295 FLOP/byte ridge, so the cache read is the whole cost and tensor cores
// would not help.
//
// What the design does about it: the TPU kernel ran the tile axis as a
// sequential grid dimension carrying the softmax state in VMEM; here the tile
// loop runs inside one block per (kv head, batch row), with the state in
// shared memory and registers, so the cache is streamed exactly once with
// 16-byte loads and the stacked layer is addressed by offset (no copy).
// Known limit, first for a later change: at B=1 that is KV = 8 blocks on 132
// SMs, so a call reaches only a fraction of the card's memory rate; a split
// of the tile loop over more blocks plus a combine pass fixes it.
//
// The tile size is mirrored in kernels/decode_attention.py (K2_BLOCK_K). K4's
// bf16 and int8-dequantizing modes (fold_heads=True) launch this kernel too:
// folding the KV heads has no numerical meaning.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head_dim
constexpr int THREADS = 128;    // one output column d per thread and head
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK_K = 64;     // cache positions per tile
constexpr int G = 4;            // query heads per KV head: Llama-3.1-8B's 32 / 8
constexpr int KPAD = D + 2;     // shared row stride in bf16: 65 words, conflict-free columns
constexpr float NEG_INF = -1e30f;

// A tile row of 16 int8 values dequantized with its position's scale:
// bf16(float(int8) * float(scale)) is the bf16 product, exactly rounded.
__device__ __forceinline__ void dequant16(const uint4 raw, const float s,
                                          __nv_bfloat16* dst) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    d2[i] = __floats2bfloat162_rn((float)e[2 * i] * s, (float)e[2 * i + 1] * s);
}

// CacheT is __nv_bfloat16 (K2) or int8_t (K3, with k_scale / v_scale).
template <typename CacheT>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,   // [B, 1, H, D]
                    const CacheT* __restrict__ k,          // [L, B, KV, T, D]
                    const CacheT* __restrict__ v,          // [L, B, KV, T, D]
                    const __nv_bfloat16* __restrict__ k_scale,  // [L, B, KV, T] (int8)
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ start_pos,     // [B]
                    __nv_bfloat16* __restrict__ out,       // [B, 1, H, D]
                    int B, int H, int KV, int T, int layer, float scale) {
  __shared__ float qs[G][D];
  __shared__ __align__(16) __nv_bfloat16 ks[BLOCK_K][KPAD];
  __shared__ __align__(16) __nv_bfloat16 vs[BLOCK_K][KPAD];
  __shared__ float ps[G][BLOCK_K];
  __shared__ float m_s[G], l_s[G], corr_s[G];

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int pos = start_pos[b];
  const int n_keys = min(pos + 1, T);
  const int n_tiles = (n_keys + BLOCK_K - 1) / BLOCK_K;

  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int i = tid; i < G * D; i += THREADS) qs[i / D][i % D] = __bfloat162float(qh[i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  const size_t head = ((size_t)layer * B + b) * KV + kvh;
  const CacheT* kh = k + head * (size_t)T * D;
  const CacheT* vh = v + head * (size_t)T * D;
  constexpr int PER_LOAD = 16 / sizeof(CacheT);        // elements per 16-byte load

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = kt * BLOCK_K;
    __syncthreads();  // previous tile's reads of ks/vs/ps are done
    for (int idx = tid; idx < BLOCK_K * (D / PER_LOAD); idx += THREADS) {
      const int r = idx / (D / PER_LOAD), c = (idx % (D / PER_LOAD)) * PER_LOAD;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = make_uint4(0, 0, 0, 0);
      const bool visible = t0 + r < n_keys;
      if (visible) {
        kval = *reinterpret_cast<const uint4*>(kh + (size_t)(t0 + r) * D + c);
        vval = *reinterpret_cast<const uint4*>(vh + (size_t)(t0 + r) * D + c);
      }
      if constexpr (sizeof(CacheT) == 1) {
        float sk = 0.f, sv = 0.f;
        if (visible) {
          sk = __bfloat162float(k_scale[head * T + t0 + r]);
          sv = __bfloat162float(v_scale[head * T + t0 + r]);
        }
        dequant16(kval, sk, &ks[r][c]);
        dequant16(vval, sv, &vs[r][c]);
      } else {
        uint32_t* kd = reinterpret_cast<uint32_t*>(&ks[r][c]);
        uint32_t* vd = reinterpret_cast<uint32_t*>(&vs[r][c]);
        kd[0] = kval.x; kd[1] = kval.y; kd[2] = kval.z; kd[3] = kval.w;
        vd[0] = vval.x; vd[1] = vval.y; vd[2] = vval.z; vd[3] = vval.w;
      }
    }
    __syncthreads();

    // scores: one (head, position) pair per thread and step, fp32 dot over D
    for (int idx = tid; idx < G * BLOCK_K; idx += THREADS) {
      const int g = idx / BLOCK_K, j = idx % BLOCK_K;
      float sc = NEG_INF;
      if (t0 + j < n_keys) {
        float dot = 0.f;
        const __nv_bfloat162* krow = reinterpret_cast<const __nv_bfloat162*>(&ks[j][0]);
#pragma unroll 8
        for (int d2 = 0; d2 < D / 2; ++d2) {
          const float2 kf = __bfloat1622float2(krow[d2]);
          dot = fmaf(qs[g][2 * d2], kf.x, dot);
          dot = fmaf(qs[g][2 * d2 + 1], kf.y, dot);
        }
        sc = dot * scale;
      }
      ps[g][j] = sc;
    }
    __syncthreads();

    // online softmax: one warp per head row, two positions per lane
    for (int g = warp; g < G; g += WARPS) {
      const float s0 = ps[g][lane], s1 = ps[g][lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // PV takes p rounded to bf16; l sums the fp32 values
      ps[g][lane] = __bfloat162float(__float2bfloat16(p0));
      ps[g][lane + 32] = __bfloat162float(__float2bfloat16(p1));
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: thread tid owns column d = tid of every head row
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float a = acc[g] * corr_s[g];
      for (int j = 0; j < BLOCK_K; ++j)
        a = fmaf(ps[g][j], __bfloat162float(vs[j][tid]), a);
      acc[g] = a;
    }
  }
  __syncthreads();

  __nv_bfloat16* oh = out + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int g = 0; g < G; ++g)
    oh[g * D + tid] = __float2bfloat16(acc[g] / fmaxf(l_s[g], 1e-30f));
}

template <typename CacheT>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* start_pos, void* out, int B, int H,
           int KV, int T, int layer, float scale, void* stream) {
  if (H != KV * G) return (int)cudaErrorInvalidValue;
  dim3 grid(KV, B);
  flash_decode_kernel<CacheT><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CacheT*>(k),
      static_cast<const CacheT*>(v), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(start_pos),
      static_cast<__nv_bfloat16*>(out), B, H, KV, T, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 = launched). Shapes are checked by the Python
// wrapper; H / KV must be G.
extern "C" int lnb_flash_decode_attention(const void* q, const void* k,
                                          const void* v, const void* start_pos,
                                          void* out, int B, int H, int KV,
                                          int T, int layer, float scale,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, start_pos, out, B, H, KV,
                               T, layer, scale, stream);
}

extern "C" int lnb_flash_decode_attention_q8(const void* q, const void* k,
                                             const void* v, const void* k_scale,
                                             const void* v_scale,
                                             const void* start_pos, void* out,
                                             int B, int H, int KV, int T,
                                             int layer, float scale, void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, start_pos, out, B, H, KV, T,
                        layer, scale, stream);
}
