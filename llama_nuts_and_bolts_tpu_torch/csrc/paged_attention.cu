// K6 and K7: S=1 decode attention over a paged KV pool (head_dim 128, G = 4
// query heads per KV head), each batch row walking its own block table.
//
// Replaces the Pallas kernels of llama_nuts_and_bolts_tpu/kernels/paged_attention.py:
//   * K6, paged_flash_decode(fold_heads=True) -> _paged_kernel_heads, over a
//     stacked pool [L * n_blocks, KV, bs, D] read at flat block index
//     layer * n_blocks + table[b, e]:
//       - bf16 pool: the online softmax updates once per span of `chunk`
//         consecutive table entries (chunk * bs keys, 512 at bs = 32), as the
//         Pallas kernel concatenates them into one tile;
//       - int8 pool with bf16 scales: q quantized per row, int8 x int8 ->
//         int32 score dots with the k scales folded in, and one update per
//         (head, bs-key block) with p folded with the v scales and quantized
//         over that block (kernels/quant_attn_math.py).
//   * K7, paged_flash_decode(fold_heads=False) -> _paged_kernel: bf16 only,
//     single-layer pool, one update per bs-key block: this kernel with
//     chunk = 1 and layer = 0.
// Batch row b attends the pool slots holding positions t <= positions[b]:
// the entries table[b, 0 .. positions[b] / bs] (none when the position is
// negative: the row's output is zeros); nothing past the position is read.
// Masked scores at -1e30, l floored at 1e-30, p rounded to bf16 before the
// PV product (bf16 pools).
//
// What bounds it on the H100: bytes. Each visible pool row of k and v is read
// once: sum_b (pos_b + 1) * KV * D * 2 bytes each for bf16 (1 byte plus 2
// bytes of scale per row and head for int8) against 4 * H * D operations
// per key, one or two per byte -- far below the ~295 FLOP/byte ridge. At
// B = 4, every row at position 2047, that is 0.0100 ms (bf16) and 0.0051 ms
// (int8).
//
// What replaced what. The first design ran one block of 128 threads
// per (KV head, batch row) -- 32 blocks at B = 4, 8 at B = 1, on 132 SMs --
// staging each 32-key block with plain loads between two barriers, the v
// blocks in a second pass, and in int8 each k row read four times from
// device memory: on an H100 80GB HBM3 at 700 W, 0.0167 ms (bf16) and 0.0177
// ms (int8) at B = 4, position 114; 0.2188 and 0.2776 ms with every row at
// 2047; K7 0.0184 ms at 114 (PERF.md's kernel table). This design:
//   * Grid (splits, KV, B): split s of row b walks table entries
//     [s * split, (s + 1) * split). `split` is a function of B, KV, M and bs
//     only (kernels/paged_attention.py::paged_split, about 256 blocks when
//     every split is active), so the positions stay on the card. A block
//     reads its own table slice and position; a split that starts past the
//     row's last used entry exits at once. The split is the launch's slowest
//     index, so the always-active split-0 blocks are dispatched first.
//   * One producer warp (one thread) streams the split's visible (pool
//     block, KV head) slices -- contiguous runs of bs rows, 8 KB of k in
//     bf16, 4 KB in int8 with 64 B of each scale -- with 1-D bulk async
//     copies (cp.async.bulk) into a ring of STAGES slots counted on
//     mbarriers, only the rows up to the position, in the order they are
//     used: per span the k slices, then the v slices, so v arrives while the
//     span's softmax runs. A slot is refilled once the eight consumer warps
//     have read it (an `empty` mbarrier), so the next copies stay in flight
//     while the current slice is computed.
//   * Scores: 8 lanes a key, each 32 bytes of the row (bf16: two 16-byte
//     reads; int8: one), so a quarter warp reads one row without a bank
//     conflict and each row is read once for all G = 4 heads; q in
//     registers; the 4 head sums are reduce-scattered over the 8 lanes in 4
//     shuffles. bf16 on CUDA cores (fp32 FMA; ~2 FLOP per byte leaves no
//     work for tensor cores), int8 on __dp4a.
//   * bf16: the span's scores stay in shared memory (up to 512 keys x 4
//     heads), one update per span, p rounded to bf16, then PV: a thread per
//     column pair and quarter of the keys, all 4 heads, the quarters summed
//     once at the end.
//   * int8: the loop takes GROUP = 4 pool blocks a pass (its copies are
//     ordered as a bf16 span's), each still its own update: the scores of
//     the group, then every block's update and p's quantization at once (a
//     warp per (head, block pair), a lane per key; the running max m_j
//     after each block is a prefix max of the blocks' maxima, which every
//     warp of a head takes), then PV on __dp4a: a warp per (head, half of
//     the keys), a lane per 4 columns, 4 rows of v transposed in registers
//     (__byte_perm) so each __dp4a multiplies 4 keys of p_i by 4 of v; then
//     half 0 folds each block's exact int32 sum (both halves) into the fp32
//     acc, and l, in block order. Three barriers a group instead of two a
//     block: the per-block chain of reductions, not the bytes, set the
//     first version's time.
//   * No second launch combines the splits. Each split writes its fp32
//     (m, l, acc) to a workspace and draws a ticket from a per-(row, KV head)
//     counter; the block that draws the last ticket of the row's active
//     splits loads every split's (m, l) at once, combines in split order
//     (m = max m_i, l = sum l_i e^(m_i - m), out = sum acc_i e^(m_i - m) /
//     max(l, 1e-30)) and resets the counter to 0. A row with one active split
//     writes its output directly. The workspace and counters are the
//     wrapper's, made once per shape and stream.
// A split cuts the bf16 spans at its edges (the Pallas spans intersected
// with the split), so p is rounded relative to the split's running max; the
// int8 quantization rows are single pool blocks, which a split never cuts.
// kernels/paged_attention.py mirrors the partition (PagedGeometry) and the
// combine in its plain versions. Copies need 16-byte runs: bs a multiple of
// 8 (the int8 scales' bs * 2 bytes), at most 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;               // head_dim
constexpr int G = 4;                 // query heads per KV head: Llama-3.1-8B's 32 / 8
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = CONSUMER_WARPS * 32;
constexpr int THREADS = CONSUMERS + 32;   // and the producer warp
constexpr int STAGES = 8;            // slots of the copy ring
constexpr int MAX_BS = 64;           // block sizes the kernel takes (the pool's is 32)
constexpr int MAX_SPAN = 512;        // keys per bf16 softmax update: chunk * bs <= 512
constexpr int GROUP = 4;             // int8: pool blocks a pass of the loop takes
constexpr int MAX_SPLITS = 256;      // splits of a row (kernels/paged_attention.py)
constexpr int SPLIT_LOADS = 32;      // partials in flight per thread in the combine
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a block may use (227 KB)
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// the fixed part of the shared-memory layout, in bytes
constexpr int OFF_STATE = 2 * STAGES * 8;        // after the full and empty mbarriers
constexpr int OFF_QW = OFF_STATE + 128;          // m, l, corr, qs * scale [G]; a flag
constexpr int OFF_TABLE = OFF_QW + G * D;        // q_i: int8 [G][D] (int8 pools)

struct Layout {
  int stage_bytes, scores, ring, smem;
};

// After the fixed part: the split's table slice, the scores (bf16: [span][G]
// fp32; int8: per block of a group its scores, v scales, PV half sums, four
// statistics and p_i), then the ring. Once every copy is consumed the ring holds
// the epilogue: the key quarters' acc [4][G][D] and the combine's weights.
__host__ __device__ inline Layout layout(bool int8, int bs, int chunk, int split) {
  Layout s;
  const int rows = bs * D * (int8 ? 1 : 2);
  s.stage_bytes = int8 ? (rows + 4 * bs + 127) & ~127 : rows;   // k rows, ks, vs
  s.scores = OFF_TABLE + ((4 * split + 127) & ~127);
  const int span = (chunk < split ? chunk : split) * bs;
  const int score_bytes = int8 ? GROUP * (4 * G * bs + 4 * bs + 4 * G * D + 16 * G + G * bs)
                               : 4 * G * span;
  s.ring = (s.scores + score_bytes + 127) & ~127;
  int ring = STAGES * s.stage_bytes;
  const int tail = 4 * (4 * G * D + 2 * MAX_SPLITS * G);
  if (ring < tail) ring = tail;
  s.smem = s.ring + ring;
  return s;
}

__device__ __forceinline__ int clip127(float x) {
  return (int)fminf(fmaxf(rintf(x), -127.f), 127.f);
}

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

// bytes (a multiple of 16) from src to dst, both 16-byte aligned, reported to bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// the consumer warps only (the producer warp has left)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// The end of the span (int8: the group) that starts at table entry a: the
// next multiple of chunk (bf16: the Pallas span's end) or the split's end
// e1, whichever is first.
__device__ __forceinline__ int span_end(int a, int e1, int chunk) {
  return min((a / chunk + 1) * chunk, e1);
}

// 8 bf16 values of a 16-byte piece as fp32
__device__ __forceinline__ void unpack8(const uint4 raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// The G head sums of one key, each split over the 8 lanes u = lane & 7 of a
// quarter warp, reduce-scattered in 4 shuffles: lane u returns the whole sum
// of head (u >> 1) & 3 (lanes u and u ^ 1 the same value).
template <typename T>
__device__ __forceinline__ T reduce_scatter(const T (&d)[G], int u) {
  const bool hi = (u >> 2) & 1, mid = (u >> 1) & 1;
  T k0 = hi ? d[2] : d[0], k1 = hi ? d[3] : d[1];
  const T s0 = hi ? d[0] : d[2], s1 = hi ? d[1] : d[3];
  k0 += __shfl_xor_sync(FULL, s0, 4);
  k1 += __shfl_xor_sync(FULL, s1, 4);
  T k = mid ? k1 : k0;
  k += __shfl_xor_sync(FULL, mid ? k0 : k1, 2);
  return k + __shfl_xor_sync(FULL, k, 1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 2)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,         // [B, 1, H, D]
                   const uint8_t* __restrict__ pool_k,          // [L * n_blocks, KV, bs, D]
                   const uint8_t* __restrict__ pool_v,
                   const __nv_bfloat16* __restrict__ pool_ks,   // [L * n_blocks, KV, bs] (int8)
                   const __nv_bfloat16* __restrict__ pool_vs,
                   const int* __restrict__ tables,              // [B, M]
                   const int* __restrict__ positions,           // [B]
                   __nv_bfloat16* __restrict__ out,             // [B, 1, H, D]
                   float* __restrict__ part_acc,                // [B, KV, splits, G, D]
                   float* __restrict__ part_ml,                 // [B, KV, splits, G, 2]
                   int* __restrict__ tickets,                   // [B, KV], 0 between calls
                   int H, int KV, int M, int n_blocks, int bs, int chunk, int split,
                   int layer, float scale) {
  constexpr int ELT = INT8 ? 1 : 2;
  extern __shared__ __align__(128) uint8_t smem[];
  // (splits, KV, B) blocks, launched with the split slowest (blockIdx.z), so
  // the blocks of split 0, which always run, are dispatched first and the
  // ones past a row's position last
  const int s = blockIdx.z, kvh = blockIdx.x, b = blockIdx.y;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, u = lane & 7;
  const Layout lay = layout(INT8, bs, chunk, split);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  float* m_s = reinterpret_cast<float*>(smem + OFF_STATE);
  float* l_s = m_s + G;
  float* corr_s = l_s + G;                    // bf16: the span's update factor
  float* qsc_s = corr_s + G;                  // int8: q's scale * softmax scale
  int* last_s = reinterpret_cast<int*>(qsc_s + G);
  int* tbl_s = reinterpret_cast<int*>(smem + OFF_TABLE);
  // bf16: the span's scores, then p, [span][G]. int8, per block j of a
  // group: scores s_f [GROUP][G][bs], v scales [GROUP][bs], half 1's PV sums
  // [GROUP][G][D], the running max, update factor, p scale and sum of p
  // [4][GROUP][G], and p_i [GROUP][G][bs]
  float* ps = reinterpret_cast<float*>(smem + lay.scores);
  float* vsc = ps + GROUP * G * bs;
  int* part = reinterpret_cast<int*>(vsc + GROUP * bs);
  float* bstat = reinterpret_cast<float*>(part + GROUP * G * D);
  int8_t* p_i = reinterpret_cast<int8_t*>(bstat + 4 * GROUP * G);
  uint8_t* ring = smem + lay.ring;
  const __nv_bfloat16* qh = q + ((size_t)b * H + (size_t)kvh * G) * D;

  // The position, the split's table slice (producer warp) and q (consumer
  // warps) are read at once: none depends on another, so the first copy
  // waits for one round trip to memory.
  const int pos = positions[b];
  const int e0 = s * split;
  // q of this lane's part of a key: bf16, dims [8u, 8u + 8) and [64 + 8u,
  // 64 + 8u + 8) of every head in fp32; int8, 4 columns of row `warp` to
  // quantize (warps 0-3), then bytes [16u, 16u + 16) of every row of q_i
  float qr[INT8 ? 1 : G][16];
  float qx[4];
  int4 qw[G];
  if (warp == CONSUMER_WARPS) {
    for (int i = lane; i < min(split, M - e0); i += 32) tbl_s[i] = tables[(size_t)b * M + e0 + i];
  } else if constexpr (INT8) {
    if (warp < G)
#pragma unroll
      for (int i = 0; i < 4; ++i) qx[i] = __bfloat162float(qh[warp * D + 4 * lane + i]);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint4* row = reinterpret_cast<const uint4*>(qh + g * D);
      unpack8(row[u], qr[g]);
      unpack8(row[u + 8], qr[g] + 8);
    }
  }
  const int n_entries = pos < 0 ? 0 : min(pos / bs, M - 1) + 1;
  // split 0 always runs, so a row with nothing visible still writes its zeros
  const int n_active = max(1, (n_entries + split - 1) / split);
  if (s >= n_active) return;
  const int e1 = max(e0, min(e0 + split, n_entries));

  if (warp == CONSUMER_WARPS) {
    // the producer: per span (int8: per group of blocks) the k slices (int8:
    // with both scale rows), then the v slices, only the visible rows; a
    // slot is refilled once the consumer warps have read it. The consumers wait
    // at named barrier 2 for the mbarriers' initialisation, not for this.
    if (lane == 0) {
      for (int i = 0; i < STAGES; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], CONSUMER_WARPS);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncwarp();
    asm volatile("bar.arrive 2, %0;\n" ::"n"(THREADS) : "memory");
    if (lane == 0) {
      const size_t layer_base = (size_t)layer * n_blocks;
      int n = 0;
      for (int a = e0; a < e1;) {
        const int a1 = span_end(a, e1, chunk);
        for (int kind = 0; kind < 2; ++kind) {
          for (int e = a; e < a1; ++e, ++n) {
            const int st = n % STAGES;
            if (n >= STAGES) mbar_wait(&empty[st], (n / STAGES - 1) & 1);
            const int nv = min(bs, pos + 1 - e * bs);
            const size_t slice = (layer_base + tbl_s[e - e0]) * KV + kvh;
            uint8_t* dst = ring + st * lay.stage_bytes;
            const uint32_t rows = (uint32_t)nv * D * ELT;
            const uint8_t* src = (kind ? pool_v : pool_k) + slice * bs * D * ELT;
            if (INT8 && kind == 0) {
              const uint32_t sb = (uint32_t)((nv + 7) & ~7) * 2;   // whole 16-byte units
              mbar_expect_tx(&full[st], rows + 2 * sb);
              bulk_load(dst, src, rows, &full[st]);
              bulk_load(dst + bs * D, pool_ks + slice * bs, sb, &full[st]);
              bulk_load(dst + bs * D + 2 * bs, pool_vs + slice * bs, sb, &full[st]);
            } else {
              mbar_expect_tx(&full[st], rows);
              bulk_load(dst, src, rows, &full[st]);
            }
          }
        }
        a = a1;
      }
    }
    return;
  }

  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  if constexpr (INT8) {
    // quantize the G rows (max(|q|, 1e-8) / 127, half to even): warp g owns
    // row g, 4 columns per lane
    if (warp < G) {
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) amax = fmaxf(amax, fabsf(qx[i]));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, off));
      const float qs = fmaxf(amax, 1e-8f) / 127.0f;
      uint32_t packed = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) packed |= (uint32_t)(clip127(qx[i] / qs) & 0xFF) << (8 * i);
      reinterpret_cast<uint32_t*>(smem + OFF_QW)[warp * (D / 4) + lane] = packed;
      if (lane == 0) qsc_s[warp] = qs * scale;
    }
  }
  // the mbarriers are set (the producer arrived), and so are q_i, m and l
  asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS) : "memory");
  if constexpr (INT8) {
#pragma unroll
    for (int g = 0; g < G; ++g) qw[g] = reinterpret_cast<const int4*>(smem + OFF_QW + g * D)[u];
  }

  // bf16 PV: thread tid owns columns 2c, 2c + 1 of every head over quarter
  // kq of each block's keys; int8 PV: warp (kh, g) owns head g over half kh
  // of the keys, lane the columns 4 lane .. 4 lane + 3 (kh = 0 keeps acc)
  const int c = tid & 63, kq = tid >> 6;
  const int g8 = warp & 3, kh = warp >> 2;
  float acc[G][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
  int n = 0;                                   // slots consumed

  for (int a = e0; a < e1;) {
    // bf16: one span; int8: a group of up to GROUP blocks, each its own update
    const int a1 = span_end(a, e1, chunk);

    // scores of the span: 8 lanes a key, 32 keys a pass
    for (int e = a; e < a1; ++e, ++n) {
      const int st = n % STAGES;
      mbar_wait(&full[st], (n / STAGES) & 1);
      const uint8_t* kt = ring + st * lay.stage_bytes;
      const int nv = min(bs, pos + 1 - e * bs);
      for (int t0 = 0; t0 < bs; t0 += 32) {
        const int t = t0 + warp * 4 + (lane >> 3);
        const int g = (u >> 1) & 3;
        if constexpr (INT8) {
          int d[G] = {0, 0, 0, 0};
          if (t < nv) {
            const int4 kw = *reinterpret_cast<const int4*>(kt + t * D + 16 * u);
#pragma unroll
            for (int h = 0; h < G; ++h) {
              d[h] = __dp4a(kw.x, qw[h].x, d[h]);
              d[h] = __dp4a(kw.y, qw[h].y, d[h]);
              d[h] = __dp4a(kw.z, qw[h].z, d[h]);
              d[h] = __dp4a(kw.w, qw[h].w, d[h]);
            }
          }
          const int dot = reduce_scatter(d, u);
          if (t < bs) {
            const int j = e - a;
            const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(kt + bs * D);
            if ((u & 1) == 0)
              ps[(j * G + g) * bs + t] = t < nv ? __fmul_rn(__fmul_rn((float)dot, qsc_s[g]),
                                                            __bfloat162float(ks[t]))
                                                : NEG_INF;
            if (u == 0) vsc[j * bs + t] = t < nv ? __bfloat162float(ks[bs + t]) : 0.f;
          }
        } else {
          float d[G] = {0.f, 0.f, 0.f, 0.f};
          if (t < nv) {
            const uint4* kr = reinterpret_cast<const uint4*>(kt + t * D * 2);
            float f[16];
            unpack8(kr[u], f);
            unpack8(kr[u + 8], f + 8);
#pragma unroll
            for (int i = 0; i < 16; ++i)
#pragma unroll
              for (int h = 0; h < G; ++h) d[h] = fmaf(qr[h][i], f[i], d[h]);
          }
          const float dot = reduce_scatter(d, u);
          if (t < bs && (u & 1) == 0)
            ps[((e - a) * bs + t) * G + g] = t < nv ? dot * scale : NEG_INF;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
    consumers_sync();

    if constexpr (INT8) {
      const int nb = a1 - a;
      // Each block's update and p's quantization over it: warp (jp, g) takes
      // head g of the group's blocks j = jp, jp + 2, after the running max
      // m_j = max(m_{j-1}, max of block j) that every warp of head g takes
      // from all the group's scores; keys t = lane, lane + 32.
      {
        const int g = g8, jp = kh;
        float mx[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          mx[j] = NEG_INF;
          if (j < nb)
            for (int t = lane; t < bs; t += 32) mx[j] = fmaxf(mx[j], ps[(j * G + g) * bs + t]);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int j = 0; j < GROUP; ++j) mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], off));
        float m_prev = m_s[g];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          const float m_new = fmaxf(m_prev, mx[j]);
          if (j < nb && (j & 1) == jp) {
            const float* sf = ps + (j * G + g) * bs;
            float pf[MAX_BS / 32], sum = 0.f, pmax = 0.f;
#pragma unroll
            for (int i = 0; i < MAX_BS / 32; ++i) {
              const int t = lane + 32 * i;
              pf[i] = 0.f;
              if (t < bs) {
                const float p = expf(sf[t] - m_new);
                sum += p;
                pf[i] = __fmul_rn(p, vsc[j * bs + t]);
                pmax = fmaxf(pmax, fabsf(pf[i]));
              }
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
              sum += __shfl_xor_sync(FULL, sum, off);
              pmax = fmaxf(pmax, __shfl_xor_sync(FULL, pmax, off));
            }
            const float psc = fmaxf(pmax, 1e-30f) / 127.0f;
#pragma unroll
            for (int i = 0; i < MAX_BS / 32; ++i)
              if (lane + 32 * i < bs)
                p_i[(j * G + g) * bs + lane + 32 * i] = (int8_t)clip127(pf[i] / psc);
            if (lane == 0) {
              bstat[(0 * GROUP + j) * G + g] = expf(m_prev - m_new);
              bstat[(1 * GROUP + j) * G + g] = psc;
              bstat[(2 * GROUP + j) * G + g] = sum;
              bstat[(3 * GROUP + j) * G + g] = m_new;
            }
          }
          m_prev = m_new;
        }
      }
      consumers_sync();

      // PV of the group, block by block as the v slices arrive: exact int32
      // sums over 4-key groups on __dp4a, half 1's into shared memory
      int pend[GROUP][4];
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        if (j < nb) {
          const int st = n % STAGES;
          mbar_wait(&full[st], (n / STAGES) & 1);
          ++n;
          const uint8_t* vt = ring + st * lay.stage_bytes;
          const int nv = min(bs, pos + 1 - (a + j) * bs);
          const int8_t* pj = p_i + (j * G + g8) * bs;
          int pacc[4] = {0, 0, 0, 0};
          const int half = bs / 8;               // 4-key groups a half
          for (int kg = kh * half; kg < (kh + 1) * half && 4 * kg < nv; ++kg) {
            const int r0 = 4 * kg;
            int w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              w[i] = r0 + i < nv ? *reinterpret_cast<const int*>(vt + (r0 + i) * D + 4 * lane)
                                 : 0;
            // w[i] holds v[r0+i][4*lane .. +3]; x[k] gets v[r0 .. r0+3][4*lane + k]
            const int lo01 = __byte_perm(w[0], w[1], 0x5140);
            const int hi01 = __byte_perm(w[0], w[1], 0x7362);
            const int lo23 = __byte_perm(w[2], w[3], 0x5140);
            const int hi23 = __byte_perm(w[2], w[3], 0x7362);
            const int x[4] = {(int)__byte_perm(lo01, lo23, 0x5410),
                              (int)__byte_perm(lo01, lo23, 0x7632),
                              (int)__byte_perm(hi01, hi23, 0x5410),
                              (int)__byte_perm(hi01, hi23, 0x7632)};
            const int pw = *reinterpret_cast<const int*>(pj + r0);
#pragma unroll
            for (int k = 0; k < 4; ++k) pacc[k] = __dp4a(pw, x[k], pacc[k]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[st]);
          if (kh == 1)
            *reinterpret_cast<int4*>(part + (j * G + g8) * D + 4 * lane) =
                make_int4(pacc[0], pacc[1], pacc[2], pacc[3]);
#pragma unroll
          for (int k = 0; k < 4; ++k) pend[j][k] = pacc[k];
        }
      }
      consumers_sync();

      // half 0 folds each block's exact sum into its fp32 acc in block
      // order, acc * corr + sum * ps, and l * corr + sum p, as the plain
      // version rounds them
      if (kh == 0) {
        float l = l_s[g8];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          if (j < nb) {
            const float corr = bstat[j * G + g8], psc = bstat[(GROUP + j) * G + g8];
            const int4 o = *reinterpret_cast<const int4*>(part + (j * G + g8) * D + 4 * lane);
            const int tot[4] = {pend[j][0] + o.x, pend[j][1] + o.y, pend[j][2] + o.z,
                                pend[j][3] + o.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
              acc[k >> 1][k & 1] = __fadd_rn(__fmul_rn(acc[k >> 1][k & 1], corr),
                                             __fmul_rn((float)tot[k], psc));
            l = __fadd_rn(__fmul_rn(l, corr), bstat[(2 * GROUP + j) * G + g8]);
          }
        }
        __syncwarp();
        if (lane == 0) {
          l_s[g8] = l;
          m_s[g8] = bstat[(3 * GROUP + nb - 1) * G + g8];
        }
      }
    } else {
      // the span's softmax update: warp g owns head row g
      if (warp < G) {
        const int g = warp;
        const int n_span = (a1 - a) * bs;
        float mx = NEG_INF;
        for (int i = lane; i < n_span; i += 32) mx = fmaxf(mx, ps[i * G + g]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
        const float m_old = m_s[g];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int i = lane; i < n_span; i += 32) {
          const float p = expf(ps[i * G + g] - m_new);
          sum += p;
          ps[i * G + g] = __bfloat162float(__float2bfloat16(p));   // PV takes p in bf16
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(FULL, sum, off);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = m_new;
        }
      }
      consumers_sync();

#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[g][0] *= corr_s[g];
        acc[g][1] *= corr_s[g];
      }
      // PV of the span, block by block as the v slices arrive
      for (int e = a; e < a1; ++e, ++n) {
        const int st = n % STAGES;
        mbar_wait(&full[st], (n / STAGES) & 1);
        const uint8_t* vt = ring + st * lay.stage_bytes;
        const int nv = min(bs, pos + 1 - e * bs);
        const int base = (e - a) * bs;
        const int t1 = min((kq + 1) * (bs / 4), nv);
        for (int t = kq * (bs / 4); t < t1; ++t) {
          const float2 x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(vt + (t * D + 2 * c) * 2));
          const float4 p = *reinterpret_cast<const float4*>(ps + (base + t) * G);
          acc[0][0] = fmaf(p.x, x.x, acc[0][0]);
          acc[0][1] = fmaf(p.x, x.y, acc[0][1]);
          acc[1][0] = fmaf(p.y, x.x, acc[1][0]);
          acc[1][1] = fmaf(p.y, x.y, acc[1][1]);
          acc[2][0] = fmaf(p.z, x.x, acc[2][0]);
          acc[2][1] = fmaf(p.z, x.y, acc[2][1]);
          acc[3][0] = fmaf(p.w, x.x, acc[3][0]);
          acc[3][1] = fmaf(p.w, x.y, acc[3][1]);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[st]);
      }
      consumers_sync();                        // the span's p is read; the next overwrites it
    }
    a = a1;
  }
  if constexpr (INT8) consumers_sync();        // half 0's folds are in l_s, m_s and acc

  // Every copy has landed and been read: the ring holds the key quarters'
  // acc (int8: one). Thread tid then owns columns 2j, 2j + 1 of head g for
  // the output, the partial and the combine.
  float* red = reinterpret_cast<float*>(ring);
  if constexpr (INT8) {
    if (kh == 0)
      *reinterpret_cast<float4*>(red + g8 * D + 4 * lane) =
          make_float4(acc[0][0], acc[0][1], acc[1][0], acc[1][1]);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g)
      *reinterpret_cast<float2*>(red + (kq * G + g) * D + 2 * c) = make_float2(acc[g][0], acc[g][1]);
  }
  consumers_sync();
  const int j = tid & 63, g = tid >> 6;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll
  for (int qq = 0; qq < (INT8 ? 1 : 4); ++qq) {
    const float2 x = *reinterpret_cast<const float2*>(red + (qq * G + g) * D + 2 * j);
    a0 += x.x;
    a1 += x.y;
  }

  const size_t row = (size_t)b * KV + kvh;
  __nv_bfloat16* oh = out + ((size_t)b * H + (size_t)kvh * G) * D + 2 * j;
  if (n_active == 1) {
    const float l = fmaxf(l_s[g], 1e-30f);
    store2(oh + g * D, a0 / l, a1 / l);
    return;
  }

  // this split's partial, then a ticket; the last active split combines
  float* pa = part_acc + ((row * n_splits + s) * G) * D + 2 * j;
  *reinterpret_cast<float2*>(pa + g * D) = make_float2(a0, a1);
  if (tid < G) {
    float* pm = part_ml + ((row * n_splits + s) * G + tid) * 2;
    pm[0] = m_s[tid];
    pm[1] = l_s[tid];
  }
  __threadfence();
  consumers_sync();
  if (tid == 0) *last_s = atomicAdd(&tickets[row], 1) == n_active - 1;
  consumers_sync();
  if (!*last_s) return;
  __threadfence();
  if (tid == 0) tickets[row] = 0;

  // The combine: this thread's first SPLIT_LOADS partial outputs are
  // requested first, then every split's (m, l) comes into shared memory at
  // once; per head, one warp takes m = max m_i, the weights w_i = e^(m_i -
  // m) and l = sum l_i w_i in split order; then each thread sums its outputs
  // over the splits in order.
  const float* pa_row = part_acc + row * n_splits * G * D + g * D + 2 * j;
  const float* pm_row = part_ml + row * n_splits * G * 2;
  float2 x[SPLIT_LOADS];
#pragma unroll
  for (int i = 0; i < SPLIT_LOADS; ++i)
    if (i < n_active) x[i] = __ldcg(reinterpret_cast<const float2*>(pa_row + i * G * D));
  float* w_s = red + 4 * G * D;               // past the quarters, still in the ring
  float* lp_s = w_s + MAX_SPLITS * G;
  for (int e = tid; e < n_active * G; e += CONSUMERS) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(pm_row) + e);
    w_s[e] = ml.x;
    lp_s[e] = ml.y;
  }
  consumers_sync();
  if (warp < G) {
    const int h = warp;
    float m = NEG_INF;
    for (int i = lane; i < n_active; i += 32) m = fmaxf(m, w_s[i * G + h]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
    for (int i = lane; i < n_active; i += 32) w_s[i * G + h] = expf(w_s[i * G + h] - m);
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int i = 0; i < n_active; ++i) l += lp_s[i * G + h] * w_s[i * G + h];
      l_s[h] = fmaxf(l, 1e-30f);
    }
  }
  consumers_sync();
  float o0 = 0.f, o1 = 0.f;
  for (int i0 = 0; i0 < n_active; i0 += SPLIT_LOADS) {
    if (i0 > 0) {
#pragma unroll
      for (int i = 0; i < SPLIT_LOADS; ++i)
        if (i0 + i < n_active)
          x[i] = __ldcg(reinterpret_cast<const float2*>(pa_row + (i0 + i) * G * D));
    }
#pragma unroll
    for (int i = 0; i < SPLIT_LOADS; ++i) {
      if (i0 + i < n_active) {
        const float w = w_s[(i0 + i) * G + g];
        o0 += x[i].x * w;
        o1 += x[i].y * w;
      }
    }
  }
  store2(oh + g * D, o0 / l_s[g], o1 / l_s[g]);
}

template <bool INT8>
int launch(const void* q, const void* pool_k, const void* pool_v, const void* pool_ks,
           const void* pool_vs, const void* tables, const void* positions, void* out,
           void* part_acc, void* part_ml, void* tickets, int B, int H, int KV, int M,
           int n_blocks, int bs, int chunk, int split, int layer, float scale,
           void* stream) {
  if (H != KV * G || B < 1 || M < 1 || bs < 8 || bs > MAX_BS || bs % 8 || chunk < 1 ||
      chunk * bs > MAX_SPAN || split < 1 || (M + split - 1) / split > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  const Layout lay = layout(INT8, bs, chunk, split);
  if (lay.smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // above 48 KB a kernel needs its limit raised (once per size and process)
  static int smem_allowed = 48 * 1024;
  if (lay.smem > smem_allowed) {
    cudaFuncSetAttribute(paged_split_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         lay.smem);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    smem_allowed = lay.smem;
  }
  dim3 grid(KV, B, (M + split - 1) / split);
  paged_split_kernel<INT8><<<grid, THREADS, lay.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(pool_k),
      static_cast<const uint8_t*>(pool_v), static_cast<const __nv_bfloat16*>(pool_ks),
      static_cast<const __nv_bfloat16*>(pool_vs), static_cast<const int*>(tables),
      static_cast<const int*>(positions), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), static_cast<int*>(tickets),
      H, KV, M, n_blocks, bs, chunk, split, layer, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 = launched). Shapes, types, devices and
// alignment are checked by the Python wrapper (kernels/paged_attention.py);
// H / KV must be G, bs a multiple of 8 up to 64, chunk * bs at most 512 and
// ceil(M / split) at most 256. part_acc holds B * KV * splits * G * D floats,
// part_ml B * KV * splits * G * 2, tickets B * KV ints that are 0 on entry
// (and are 0 again on exit).
extern "C" int lnb_paged_decode(const void* q, const void* pool_k, const void* pool_v,
                                const void* tables, const void* positions, void* out,
                                void* part_acc, void* part_ml, void* tickets, int B, int H,
                                int KV, int M, int n_blocks, int bs, int chunk, int split,
                                int layer, float scale, void* stream) {
  return launch<false>(q, pool_k, pool_v, nullptr, nullptr, tables, positions, out, part_acc,
                       part_ml, tickets, B, H, KV, M, n_blocks, bs, chunk, split, layer,
                       scale, stream);
}

extern "C" int lnb_paged_decode_int8(const void* q, const void* pool_k, const void* pool_v,
                                     const void* pool_ks, const void* pool_vs,
                                     const void* tables, const void* positions, void* out,
                                     void* part_acc, void* part_ml, void* tickets, int B,
                                     int H, int KV, int M, int n_blocks, int bs, int split,
                                     int layer, float scale, void* stream) {
  return launch<true>(q, pool_k, pool_v, pool_ks, pool_vs, tables, positions, out, part_acc,
                      part_ml, tickets, B, H, KV, M, n_blocks, bs, GROUP, split, layer, scale,
                      stream);
}
