// K1: causal, cache-bounded GQA flash attention for prefill (bf16, head_dim 128).
//
// Replaces the Pallas kernel llama_nuts_and_bolts_tpu/kernels/attention.py
// (flash_gqa_attention -> _flash_kernel). Query row s sits at start_pos + s
// and sees cache slot t iff t <= start_pos + s. Online fp32 softmax over
// 128-key tiles, the G query heads of one KV head folded into the row
// dimension, p rounded to bf16 before the PV product, masked scores at
// -1e30, l floored at 1e-30.
//
// What bounds it on the H100: at prefill widths (S, T in the thousands) the
// QK^T and PV products, i.e. tensor-core operations: 4 * H * D FLOPs per
// visible (row, key) pair, 137.5 GFLOP at S = T = 4096, 0.139 ms at the
// published 989 TFLOP/s; only wgmma reaches that rate. The K/V bytes are
// re-read once per q tile, from L2.
//
// What replaced what. The first design ran mma.sync with every K/V tile
// loaded synchronously by all threads, each PV B-fragment built from four
// scalar shared-memory reads, every tile masked and the q tiles launched in
// ascending order: 1.3363 ms at S = T = 4096 (its last time, kept in
// PERF.md's kernel table). This design:
//   * a block per (kv head, q tile, batch row) owns 128 rows = 32 positions
//     x G heads, so each K/V tile serves all G heads of its group; two
//     consumer warpgroups own 64 rows each, and one producer warp issues
//     every load;
//   * TMA brings the Q tile (a 4-D box over (D, H, S, B): the G heads of a
//     KV head are adjacent) and the K and V tiles (boxes of 128 consecutive
//     keys of one [T, D] head) into 128-byte-swizzled shared memory, D = 128
//     as two 64-column halves; a ring of STAGES K/V tiles under full/empty
//     mbarriers keeps the next tile in flight;
//   * both products on wgmma m64n128k16 with fp32 accumulators in registers:
//     S = Q K^T with Q and K from shared memory (K-major); O += P V with P
//     from registers as the A operand and V from shared memory through the
//     transposed-B bit (MN-major);
//   * the softmax in registers, in the log2 domain (exp2f of pre-scaled
//     scores); only tiles that cross a warpgroup's diagonal or the cache end
//     are masked, and key tiles past the block's last row are never loaded;
//   * the grid's fastest axis is the kv head and its next the q tile in
//     descending order, so the heaviest causal blocks start first.
// ptxas (sm_90a): 168 registers, an 8-byte stack frame, 8 bytes of spill
// stores and 16 of spill loads -- a little spilling at the 168-register cap
// that 288 threads leave a thread.
// Not done: overlap of one tile's softmax with the other tile's products
// inside a warpgroup, and a persistent grid. The overlap keeps S, P and O
// in registers at once; at 288 (or 384) threads ptxas gives a thread 168
// registers (three warps share an SM quarter's 16K), setmaxnreg did not
// change that, so it serialised the wgmmas and spilled. With 64-key tiles
// it fit without spills, but the narrower S product cost more than the
// overlap won: on an H100 both versions ran slower than this one at
// S = T = 4096 and 8192.
//
// TMA descriptors come from cuTensorMapEncodeTiled, resolved at run time
// through cudaGetDriverEntryPoint, so the library links only the CUDA
// runtime; they are encoded per call, since the layer's base pointer
// changes, and passed as __grid_constant__ parameters. Launch geometry is
// mirrored in kernels/attention.py (K1_ROWS, K1_BLOCK_K, k1_geometry).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head_dim
constexpr int G = 4;            // query heads per KV head: Llama-3.1-8B's 32 / 8
constexpr int WG_ROWS = 64;     // rows of a consumer warpgroup: 16 positions x G heads
constexpr int CONSUMERS = 2;    // consumer warpgroups
constexpr int ROWS = CONSUMERS * WG_ROWS;
constexpr int BQ = ROWS / G;    // positions per block
constexpr int BLOCK_K = 128;    // keys per tile
constexpr int STAGES = 2;       // K/V tiles in the shared-memory ring
constexpr int CONSUMER_THREADS = CONSUMERS * 128;
constexpr int THREADS = CONSUMER_THREADS + 32;   // and one producer warp
constexpr int SWIZZLE_COLS = 64;                 // bf16 in a 128-byte swizzled row
constexpr int Q_HALF = ROWS * 128;               // one column half of the Q tile
constexpr int KV_HALF = BLOCK_K * 128;           // one column half of a K or V tile
constexpr int STAGE_BYTES = 4 * KV_HALF;         // K and V, two halves each
constexpr int SMEM = 1024 + 2 * Q_HALF + STAGES * STAGE_BYTES;  // + 1024-byte alignment
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival that also sets the bytes the barrier's phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor in 128-byte swizzle: start address,
// leading and stride byte offsets (K-major: the stride between 8-row groups,
// 1024; MN-major: the leading offset steps between 64-column halves)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory,
// both K-major in 128-byte swizzle; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the mma.sync
// m16n8k16 A fragment of each warp's 16 rows), B from shared memory,
// MN-major (transposed) in 128-byte swizzle
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 1)
flash_gqa_kernel(const __grid_constant__ CUtensorMap q_map,   // q [B, S, H, D] as (D, H, S, B)
                 const __grid_constant__ CUtensorMap k_map,   // k [B, KV, T, D] as (D, T, B*KV)
                 const __grid_constant__ CUtensorMap v_map,
                 __nv_bfloat16* __restrict__ out,             // [B, S, H, D]
                 int S, int H, int KV, int T, int start_pos, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // [Q: two column halves of ROWS x 128 B][STAGES x (K, V: two halves of BLOCK_K x 128 B)]
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t q_full, full[STAGES], empty[STAGES];

  const int kvh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  // keys up to the last position any row of this tile may see
  const int kv_end = min(T, start_pos + (qt + 1) * BQ);
  const int n_tiles = (kv_end + BLOCK_K - 1) / BLOCK_K;

  if (tid == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= CONSUMER_THREADS) {
    // the producer warp: one thread issues every load; rows past S and keys
    // past T arrive as zeros
    if (tid == CONSUMER_THREADS) {
      mbar_expect_tx(&q_full, 2 * Q_HALF);
      for (int h = 0; h < 2; ++h)
        tma_load_4d(smem + h * Q_HALF, &q_map, &q_full, h * SWIZZLE_COLS, kvh * G, qt * BQ, b);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* st = smem + 2 * Q_HALF + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        for (int h = 0; h < 2; ++h) {
          tma_load_3d(st + h * KV_HALF, &k_map, &full[s], h * SWIZZLE_COLS, kt * BLOCK_K,
                      b * KV + kvh);
          tma_load_3d(st + (2 + h) * KV_HALF, &v_map, &full[s], h * SWIZZLE_COLS,
                      kt * BLOCK_K, b * KV + kvh);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 rows; this thread's rows a and b = a + 8 (the
  // fragment rows of its warp), each the row of one (position, head)
  const int wg = tid >> 7, t = tid & 127, warp = t >> 5, lane = t & 31, tig = lane & 3;
  const int row_a = wg * WG_ROWS + 16 * warp + (lane >> 2), row_b = row_a + 8;
  const int pos_a = qt * BQ + row_a / G, pos_b = qt * BQ + row_b / G;
  const int head_a = kvh * G + row_a % G, head_b = kvh * G + row_b % G;
  const int qpos_a = start_pos + pos_a, qpos_b = start_pos + pos_b;
  const int q_first = start_pos + qt * BQ + wg * (WG_ROWS / G);  // the warpgroup's first position
  const uint32_t q_addr = smem_u32(smem) + wg * WG_ROWS * 128;
  const uint32_t ring = smem_u32(smem) + 2 * Q_HALF;

  float o[64];                   // O: columns 8j + 2 tig, +1 of rows a (o[4j], o[4j+1]) and b
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  // m in units of raw scores; l summed per thread, over the quad at the end
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  const float sl2 = scale * LOG2E;
  mbar_wait(&q_full, 0);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int s = kt % STAGES;
    const uint32_t k_tile = ring + s * STAGE_BYTES, v_tile = k_tile + 2 * KV_HALF;
    mbar_wait(&full[s], (kt / STAGES) & 1);

    // S = Q K^T: 64 rows x 128 keys, eight k-steps of 16 over D's two halves
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int half = kk / 4, off = (kk % 4) * 32;
      wgmma_ss(sc, smem_desc(q_addr + half * Q_HALF + off, 16, 1024),
               smem_desc(k_tile + half * KV_HALF + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    // only a tile that crosses a row's diagonal or the cache end is masked
    const int t0 = kt * BLOCK_K;
    if (t0 + BLOCK_K - 1 > q_first || t0 + BLOCK_K > T) {
#pragma unroll
      for (int j = 0; j < BLOCK_K / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = t0 + 8 * j + 2 * tig + e;
          if (key >= T || key > qpos_a) sc[4 * j + e] = NEG_INF;
          if (key >= T || key > qpos_b) sc[4 * j + 2 + e] = NEG_INF;
        }
      }
    }

    // the online-softmax update of rows a and b
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float corr_a = exp2f((m_a - mn_a) * sl2), corr_b = exp2f((m_b - mn_b) * sl2);
    const float ms_a = mn_a * sl2, ms_b = mn_b * sl2;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < BLOCK_K / 8; ++j) {
      sc[4 * j] = exp2f(fmaf(sc[4 * j], sl2, -ms_a));
      sc[4 * j + 1] = exp2f(fmaf(sc[4 * j + 1], sl2, -ms_a));
      sc[4 * j + 2] = exp2f(fmaf(sc[4 * j + 2], sl2, -ms_b));
      sc[4 * j + 3] = exp2f(fmaf(sc[4 * j + 3], sl2, -ms_b));
      sum_a += sc[4 * j] + sc[4 * j + 1];
      sum_b += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l_a = l_a * corr_a + sum_a;
    l_b = l_b * corr_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr_a;
      o[4 * j + 1] *= corr_a;
      o[4 * j + 2] *= corr_b;
      o[4 * j + 3] *= corr_b;
    }

    // O += bf16(P) V: the S accumulators of 16 keys are one A fragment
    uint32_t pf[BLOCK_K / 16][4];
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk) {
      pf[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pf[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pf[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pf[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BLOCK_K / 16; ++kk)
      wgmma_rs(o, pf[kk], smem_desc(v_tile + kk * 16 * 128, KV_HALF, 1024));
    wgmma_commit();
    wgmma_wait_all();
    mbar_arrive(&empty[s]);      // this thread is done with the slot
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
  __nv_bfloat16* o_a = out + (((size_t)b * S + pos_a) * H + head_a) * D;
  __nv_bfloat16* o_b = out + (((size_t)b * S + pos_b) * H + head_b) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * tig;
    if (pos_a < S)
      *reinterpret_cast<uint32_t*>(o_a + c) = pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
    if (pos_b < S)
      *reinterpret_cast<uint32_t*>(o_b + c) = pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A bf16 tensor map in 128-byte swizzle: dims and boxes innermost first,
// byte strides of every dim but the first; out-of-range elements read as 0.
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess)
      return false;
    fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// Returns a cudaError_t (0 = launched). Shapes are checked by the Python
// wrapper; H / KV must be G.
extern "C" int lnb_flash_gqa_attention(const void* q, const void* k,
                                       const void* v, void* out, int B, int S,
                                       int H, int KV, int T, int start_pos,
                                       float scale, void* stream) {
  if (H != KV * G) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  const cuuint64_t q_dims[4] = {D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t q_strides[3] = {D * 2, (cuuint64_t)H * D * 2, (cuuint64_t)S * H * D * 2};
  const cuuint32_t q_box[4] = {SWIZZLE_COLS, G, BQ, 1};
  const cuuint64_t kv_dims[3] = {D, (cuuint64_t)T, (cuuint64_t)B * KV};
  const cuuint64_t kv_strides[2] = {D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t kv_box[3] = {SWIZZLE_COLS, BLOCK_K, 1};
  if (!encode(&q_map, q, 4, q_dims, q_strides, q_box) ||
      !encode(&k_map, k, 3, kv_dims, kv_strides, kv_box) ||
      !encode(&v_map, v, 3, kv_dims, kv_strides, kv_box))
    return (int)cudaErrorInvalidValue;
  // above 48 KB a kernel needs its limit raised, once per process (one card)
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_gqa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  dim3 grid(KV, (S + BQ - 1) / BQ, B);
  flash_gqa_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), S, H, KV, T, start_pos, scale);
  return (int)cudaGetLastError();
}
