// K8: x[R, in] @ w.T with w in grouped packed int4 (R <= 32), fp32 out.
//
// Replaces the Pallas kernel llama_nuts_and_bolts_tpu/kernels/q4_matmul.py
// (q4_matmul -> _q4_matmul_kernel). packed is uint8 [G, out, K/2]: byte j of a
// group row holds element j in its low nibble and element j + K/2 in its high
// nibble, both offset by +8; scale is bf16 [G, out]. Per group, the low-half
// dot plus the high-half dot with the exact integer weights, accumulated in
// fp32, then multiplied by the group's scale and added to the fp32 result.
//
// What bounds it on the H100: bytes, at the decode shapes it serves. The
// packed weights (half a byte per weight, plus 2 bytes of scale per 256) are
// read once; x is at most 32 x 14336 bf16 and stays in L2. At R = 1 that is
// about 4 FLOPs per byte, far below the ~295 FLOP/byte ridge. At R = 32 the
// FMAs on the CUDA cores (64 per weight byte) approach the time of the bytes.
//
// What the design does about it: one block of 8 warps per 32 out rows; a warp
// reads 4 out rows of one group with 16-byte loads, 8 lanes per row, so each
// warp load is 512 contiguous bytes and every packed byte is read exactly
// once. Nibbles are unpacked in registers (2^23 + n as a float, minus 2^23 + 8:
// exact). x is staged in shared memory as fp32, a chunk of groups at a time,
// padded by 4 floats after every 16 so the 8 lanes of a row read disjoint
// banks; the 4 rows of a warp share each read (broadcast). Each lane keeps one
// fp32 sum per x row over its slice of every group, scaled per group, and the
// 8 lanes of a row are reduced once at the end. The next group's weights are
// loaded before the current one is consumed. Known limits, for a later change:
// no split of the contraction over blocks (wk/wv have 32 blocks on 132 SMs) and
// no tensor cores at R = 32 (wgmma with an in-register dequantized A).
//
// Tile constants are mirrored in kernels/q4_matmul.py (K8_OUT_TILE, K8_HALF_TILE).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 4;                   // 8 lanes per out row
constexpr int OUT_TILE = WARPS * ROWS_PER_WARP;    // out rows per block
constexpr int PIECE = 128;                         // packed bytes of a group row per pass
constexpr int X_FLOATS = 8192;                     // x chunk budget per block, before padding

// 4 floats of padding after every 16: lanes reading 16 consecutive elements at
// a 16-element stride land on disjoint sets of 4 banks
__host__ __device__ __forceinline__ int padded(int e) { return e + (e >> 4) * 4; }

// nibble (w >> shift) & 0xF minus the +8 offset, as an exact float
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return __int_as_float(0x4B000000u | ((w >> shift) & 0xFu)) - 8388616.0f;
}

template <int RB>
__global__ void __launch_bounds__(THREADS)
q4_matmul_kernel(const __nv_bfloat16* __restrict__ x,      // [R, in]
                 const uint8_t* __restrict__ packed,        // [G, out, half]
                 const __nv_bfloat16* __restrict__ scale,   // [G, out]
                 float* __restrict__ out,                   // [R, out]
                 int R, int in_dim, int out_dim, int half, int chunk) {
  extern __shared__ __align__(16) float xs[];               // [RB][padded(chunk)]
  const int K = 2 * half;
  const int stride = padded(chunk);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = blockIdx.x * OUT_TILE + warp * ROWS_PER_WARP + (lane >> 3);
  const int sub = lane & 7;                                 // 16-byte slot of a piece
  const int pieces = half / PIECE;

  float acc[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) acc[r] = 0.f;

  for (int c0 = 0; c0 < in_dim; c0 += chunk) {
    const int clen = min(chunk, in_dim - c0);
    __syncthreads();  // every read of the previous chunk is done
    // stage x[:, c0:c0+clen] as fp32; rows R..RB-1 are zeros
    const int vecs = clen / 8;
    for (int idx = tid; idx < RB * vecs; idx += THREADS) {
      const int r = idx / vecs, c = (idx - r * vecs) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < R) raw = *reinterpret_cast<const uint4*>(x + (size_t)r * in_dim + c0 + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
      const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
      const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
      float4* dst = reinterpret_cast<float4*>(xs + r * stride + padded(c));
      dst[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
      dst[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
    }
    __syncthreads();

    const int g0 = c0 / K;
    const int units = (clen / K) * pieces;                  // (group, piece) pairs
    auto load = [&](int u, uint4& w, float& s) {
      const int gi = u / pieces, pc = u - gi * pieces;
      const size_t g = (size_t)(g0 + gi);
      w = __ldg(reinterpret_cast<const uint4*>(
          packed + (g * out_dim + row) * half + pc * PIECE + sub * 16));
      s = __bfloat162float(scale[g * out_dim + row]);
    };
    uint4 w_next;
    float s_next;
    load(0, w_next, s_next);
    for (int u = 0; u < units; ++u) {
      const uint4 wv = w_next;
      const float s = s_next;
      if (u + 1 < units) load(u + 1, w_next, s_next);
      const uint32_t words[4] = {wv.x, wv.y, wv.z, wv.w};
      float wlo[16], whi[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          wlo[4 * i + b] = nibble(words[i], 8 * b);
          whi[4 * i + b] = nibble(words[i], 8 * b + 4);
        }
      }
      const int gi = u / pieces, pc = u - gi * pieces;
      const int e = gi * K + pc * PIECE + sub * 16;         // low-half element in the chunk
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float4* xl = reinterpret_cast<const float4*>(xs + r * stride + padded(e));
        const float4* xh = reinterpret_cast<const float4*>(xs + r * stride + padded(e + half));
        float lo = 0.f, hi = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 a = xl[i], c = xh[i];
          lo = fmaf(a.x, wlo[4 * i], lo);
          lo = fmaf(a.y, wlo[4 * i + 1], lo);
          lo = fmaf(a.z, wlo[4 * i + 2], lo);
          lo = fmaf(a.w, wlo[4 * i + 3], lo);
          hi = fmaf(c.x, whi[4 * i], hi);
          hi = fmaf(c.y, whi[4 * i + 1], hi);
          hi = fmaf(c.z, whi[4 * i + 2], hi);
          hi = fmaf(c.w, whi[4 * i + 3], hi);
        }
        acc[r] = __fadd_rn(acc[r], __fmul_rn(__fadd_rn(lo, hi), s));
      }
    }
  }

  // the 8 lanes of an out row hold disjoint slices of every group
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float v = acc[r];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    v += __shfl_xor_sync(0xffffffffu, v, 4);
    if (sub == 0 && r < R) out[(size_t)r * out_dim + row] = v;
  }
}

template <int RB>
int launch(const void* x, const void* packed, const void* scale, void* out, int R,
           int in_dim, int out_dim, int G, int half, cudaStream_t stream) {
  const int K = 2 * half;
  int groups = X_FLOATS / RB / K;                           // groups of x per chunk
  groups = groups < 1 ? 1 : (groups > G ? G : groups);
  const int chunk = groups * K;
  const size_t smem = (size_t)RB * padded(chunk) * sizeof(float);
  // the limit is raised only when a launch needs more than any before it,
  // so a decode step pays no driver call (one card per process)
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        q4_matmul_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  q4_matmul_kernel<RB><<<out_dim / OUT_TILE, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(out), R, in_dim,
      out_dim, half, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched). `rows` is the compiled row bucket
// (1, 16 or 32: K8_ROW_BUCKETS) with R <= rows; shapes are checked by the
// Python wrapper, and again here for what the kernel relies on.
extern "C" int lnb_q4_matmul(const void* x, const void* packed, const void* scale,
                             void* out, int R, int rows, int in_dim, int out_dim,
                             int G, int half, void* stream) {
  if (R < 1 || R > rows || half % PIECE || out_dim % OUT_TILE || in_dim != G * 2 * half)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return launch<1>(x, packed, scale, out, R, in_dim, out_dim, G, half, st);
    case 16: return launch<16>(x, packed, scale, out, R, in_dim, out_dim, G, half, st);
    case 32: return launch<32>(x, packed, scale, out, R, in_dim, out_dim, G, half, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
