// K8: x[R, in] @ w.T with w in grouped packed int4 (R <= 32), fp32 out.
//
// Replaces the Pallas kernel llama_nuts_and_bolts_tpu/kernels/q4_matmul.py
// (q4_matmul -> _q4_matmul_kernel). packed is uint8 [G, out, K/2]: byte j of a
// group row holds element j in its low nibble and element j + K/2 in its high
// nibble, both offset by +8; scale is bf16 [G, out]. Per group, the low-half
// dot plus the high-half dot with the exact integer weights, accumulated in
// fp32, then multiplied by the group's scale and added to the fp32 result.
// The layout is read as it is: no repacked copy of the weights.
//
// What bounds it on the H100: bytes, at every shape it serves. The packed
// weights (half a byte per weight, plus 2 bytes of scale per group row) are
// read once; x is at most 32 x 14336 bf16 and stays in L2. At R = 32 that is
// 128 operations per weight byte, under the ~295 FLOP/byte ridge of the bf16
// tensor cores; on the CUDA cores' fp32 FMAs it would not be.
//
// What the design does about it:
//   * Enough blocks, and bytes in flight. A block owns a 64-row out tile and a
//     split of whole groups (kernels/q4_matmul.py::k8_split, from the shapes
//     alone): the fewest splits, at most 8, that make ~1.5 blocks per SM (wk
//     and wv, 16 tiles, take 8 splits; the 128256-row head one). Fewer splits
//     mean fewer partials to combine; kernels/k8_splits.py times each shape
//     beside half and twice its split. One producer lane streams the split's tiles
//     -- packed[g, r0:r0+64, :], 64 x K/2 contiguous bytes, and the tile's
//     128 bytes of scales -- with 1-D bulk async copies (cp.async.bulk, no
//     tensor map, so nothing links -lcuda) into a ring of 4 stages under
//     mbarriers: 33 KB in flight per block at K/2 = 128.
//   * x is staged once per block, in bf16, only the split's columns and only
//     the R real rows, with no per-group barrier. All of x does not always
//     fit (wq's x at R = 32 is 256 KB): k8_split bounds a split's x slice to
//     X_BYTES beside the ring, so a block holds at most ~101 KB and two fit an
//     SM.
//   * Tensor cores: mma.sync m16n8k16 bf16 -> fp32, operands swapped. A is the
//     weight tile (16 out rows x 16 k, one warp's rows), dequantized in
//     registers; B is x (16 k x 8 x rows) from shared memory; R takes 1, 2 or
//     4 n-tiles (row buckets 8, 16, 32), rows past R are zero registers.
//     mma.sync rather than wgmma: at <= 128 FLOP per weight byte the tensor
//     pipe does not set the pace, and mma.sync needs no descriptors.
//   * Exact dequantization, two weights per lop3 and hsub2:
//     (word & 0x000F000F) | 0x43004300 read as bf16x2 is 128 + n in each half,
//     minus 136 is n - 8. A word of a packed row gives bytes (0, 2) and (1, 3)
//     of its low nibbles, then of its high nibbles (>> 4, >> 12), so an A
//     fragment's k slots (2t, 2t+1 | 2t+8, 2t+9) hold elements 4w + (0, 2 | 1,
//     3) of the low half, the next step those of the high half. x is staged in
//     the same permutation -- per word w a 16-byte block x[4w + (0, 2, 1, 3)],
//     x[K/2 + 4w + (0, 2, 1, 3)] -- so one 16-byte load gives B for two k16
//     steps; a group's dot is a sum over its k, so the permutation on both
//     sides is the same function. Thread t of a quad takes words 8t..8t+7 of
//     each 128-byte piece of a row (two 16-byte loads); word 8t + i sits in
//     block 4i + t, and a staged x row is padded by 64 bytes, so a quarter
//     warp's B loads hit 32 distinct banks.
//   * Per group a fresh fp32 fragment over its k16 steps, then acc = acc +
//     part * scale[g, row] with separate roundings; groups in order.
//   * Splits combine as K2's do (csrc/decode_attention.cu): each split writes
//     its fp32 partial [R, 64] to a workspace, draws a ticket, and the block
//     that draws the tile's last ticket adds the partials in split order
//     0..S-1, writes out and zeroes the ticket, in the same launch. No float
//     atomics: two calls on the same inputs give the same bits. With one
//     split the block writes out directly.
//
// Tile constants are mirrored in kernels/q4_matmul.py (K8_OUT_TILE,
// K8_HALF_TILE, K8_MAX_HALF, K8_X_BYTES, K8_ROW_BUCKETS).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMER_WARPS = 4;
constexpr int CONSUMERS = CONSUMER_WARPS * 32;
constexpr int THREADS = CONSUMERS + 32;            // + one producer warp
constexpr int OUT_TILE = CONSUMER_WARPS * 16;      // one m16 tile per warp
constexpr int PIECE = 128;                         // packed bytes of a group row per pass
constexpr int STAGES = 4;
constexpr int MAX_HALF = 512;
constexpr int X_BYTES = 64 * 1024;                 // the most x bytes a block stages
constexpr int X_PAD = 64;                          // bytes after each staged x row
constexpr int HEADER = 128;                        // mbarriers and the ticket flag

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

// nibbles 0-3 and 16-19 of w, each minus the +8 offset, as exact bf16x2
__device__ __forceinline__ uint32_t dequant2(uint32_t w) {
  uint32_t v = (w & 0x000F000Fu) | 0x43004300u;                   // 128 + n
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hsub2(h, __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// at most 136 registers a thread, so that three blocks fit an SM where
// their shared memory does (R <= 16)
template <int NT>
__global__ void __launch_bounds__(THREADS, 3)
q4_matmul_kernel(const __nv_bfloat16* __restrict__ x,      // [R, in]
                 const uint8_t* __restrict__ packed,        // [G, out, half]
                 const __nv_bfloat16* __restrict__ scale,   // [G, out]
                 float* __restrict__ out,                   // [R, out]
                 float* __restrict__ parts,                 // [tiles, splits, R, OUT_TILE]
                 int* __restrict__ tickets,                 // [tiles], 0 between calls
                 int R, int in_dim, int out_dim, int G, int half, int split) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int K = 2 * half;
  const int pieces = half / PIECE;
  const int tile_bytes = OUT_TILE * half;
  const int stage_bytes = tile_bytes + OUT_TILE * 2;        // the packed tile, its scales
  const int s_idx = blockIdx.x, n_splits = gridDim.x, tile = blockIdx.y;
  const int g0 = s_idx * split;
  const int ng = min(split, G - g0);
  const int r0 = tile * OUT_TILE;
  const int x_row = ng * K * 2 + X_PAD;                     // bytes of a staged x row

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + STAGES;
  int* last = reinterpret_cast<int*>(empty + STAGES);
  uint8_t* ring = smem + HEADER;
  uint8_t* xs = ring + STAGES * stage_bytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // the producer: the split's tiles in order, a stage refilled once all
    // four warps have read it
    if (lane == 0) {
      for (int i = 0; i < ng; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        uint8_t* st = ring + s * stage_bytes;
        const size_t g = (size_t)(g0 + i);
        mbar_expect_tx(&full[s], stage_bytes);
        bulk_load(st, packed + (g * out_dim + r0) * half, tile_bytes, &full[s]);
        bulk_load(st + tile_bytes, scale + g * out_dim + r0, OUT_TILE * 2, &full[s]);
      }
    }
    return;
  }

  // x[:R, the split's columns] in the fragments' order, while the ring fills:
  // row n, (group, piece) gp, block b = 4i + t holds word w = 8t + i
  const int row_blocks = ng * pieces * 32;
  for (int u = tid; u < R * row_blocks; u += CONSUMERS) {
    const int n = u / row_blocks, b = u - n * row_blocks;
    const int gp = b >> 5, w = 8 * (b & 3) + ((b & 31) >> 2);
    const int gl = gp / pieces, pc = gp - gl * pieces;
    const __nv_bfloat16* src =
        x + (size_t)n * in_dim + (size_t)(g0 + gl) * K + pc * PIECE + 4 * w;
    const uint2 lo = *reinterpret_cast<const uint2*>(src);          // x[j .. j+3]
    const uint2 hi = *reinterpret_cast<const uint2*>(src + half);   // x[K/2 + j ..]
    uint4 v;
    v.x = __byte_perm(lo.x, lo.y, 0x5410);                          // x[j], x[j+2]
    v.y = __byte_perm(lo.x, lo.y, 0x7632);                          // x[j+1], x[j+3]
    v.z = __byte_perm(hi.x, hi.y, 0x5410);
    v.w = __byte_perm(hi.x, hi.y, 0x7632);
    *reinterpret_cast<uint4*>(xs + (size_t)n * x_row + b * 16) = v;
  }
  consumers_sync();

  const int gid = lane >> 2, t = lane & 3;
  const int arow = warp * 16 + gid;                          // and arow + 8
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;

  for (int i = 0; i < ng; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const uint8_t* st = ring + s * stage_bytes;
    float part[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) part[j][c] = 0.f;
    for (int pc = 0; pc < pieces; ++pc) {
      const uint8_t* pa = st + arow * half + pc * PIECE + 32 * t;
      const uint4 p0 = *reinterpret_cast<const uint4*>(pa);
      const uint4 p1 = *reinterpret_cast<const uint4*>(pa + 16);
      const uint4 q0 = *reinterpret_cast<const uint4*>(pa + 8 * half);
      const uint4 q1 = *reinterpret_cast<const uint4*>(pa + 8 * half + 16);
      const uint32_t wa[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const uint32_t wb[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      const uint8_t* xb = xs + (size_t)gid * x_row + (i * pieces + pc) * 512 + 16 * t;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        uint4 bx[NT];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          bx[j] = make_uint4(0, 0, 0, 0);
          if (8 * j + gid < R)
            bx[j] = *reinterpret_cast<const uint4*>(xb + (size_t)8 * j * x_row + 64 * ii);
        }
        // low nibbles: rows arow, arow + 8 at slots (2t, 2t+1), then (2t+8, 2t+9)
        uint32_t a[4] = {dequant2(wa[ii]), dequant2(wb[ii]), dequant2(wa[ii] >> 8),
                         dequant2(wb[ii] >> 8)};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(part[j], a, bx[j].x, bx[j].y);
        // high nibbles: the same slots of the group's other half
        a[0] = dequant2(wa[ii] >> 4);
        a[1] = dequant2(wb[ii] >> 4);
        a[2] = dequant2(wa[ii] >> 12);
        a[3] = dequant2(wb[ii] >> 12);
#pragma unroll
        for (int j = 0; j < NT; ++j) mma(part[j], a, bx[j].z, bx[j].w);
      }
    }
    const __nv_bfloat16* sc = reinterpret_cast<const __nv_bfloat16*>(st + tile_bytes);
    const float s_lo = __bfloat162float(sc[arow]), s_hi = __bfloat162float(sc[arow + 8]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);                  // the stage is read
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] = __fadd_rn(acc[j][0], __fmul_rn(part[j][0], s_lo));
      acc[j][1] = __fadd_rn(acc[j][1], __fmul_rn(part[j][1], s_lo));
      acc[j][2] = __fadd_rn(acc[j][2], __fmul_rn(part[j][2], s_hi));
      acc[j][3] = __fadd_rn(acc[j][3], __fmul_rn(part[j][3], s_hi));
    }
  }

  // fragment c of n-tile j: x row 8j + 2t + (c & 1), out row arow + 8 (c >> 1)
  if (n_splits == 1) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = 8 * j + 2 * t + (c & 1);
        if (n < R) out[(size_t)n * out_dim + r0 + arow + 8 * (c >> 1)] = acc[j][c];
      }
    return;
  }

  // this split's partial, then a ticket; the tile's last split combines
  const size_t part_elems = (size_t)R * OUT_TILE;
  float* mine = parts + ((size_t)tile * n_splits + s_idx) * part_elems;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = 8 * j + 2 * t + (c & 1);
      if (n < R) mine[n * OUT_TILE + arow + 8 * (c >> 1)] = acc[j][c];
    }
  // one ticket a block: the barrier orders the consumers' stores before
  // thread 0's release, and the acquire in the tile's last block makes every
  // split's partial visible to its consumers after the next barrier
  consumers_sync();
  if (tid == 0) {
    int drawn;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(drawn) : "l"(tickets + tile) : "memory");
    *last = drawn == n_splits - 1;
  }
  consumers_sync();
  if (!*last) return;
  if (tid == 0) tickets[tile] = 0;

  // partials added in split order, the loads of SPLIT_LOADS splits in
  // flight together (one L2 round trip for them, not one a split)
  constexpr int PER_THREAD = 8 * NT * OUT_TILE / CONSUMERS;
  constexpr int SPLIT_LOADS = 8 / NT;
  const float* tp = parts + (size_t)tile * n_splits * part_elems;
  float o[PER_THREAD];
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) o[k] = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += SPLIT_LOADS) {
    float v[SPLIT_LOADS][PER_THREAD];
#pragma unroll
    for (int u = 0; u < SPLIT_LOADS; ++u)
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int e = tid + k * CONSUMERS;
        v[u][k] = s0 + u < n_splits && e < (int)part_elems
                      ? __ldcg(tp + (size_t)(s0 + u) * part_elems + e) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < SPLIT_LOADS; ++u)
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k)
        if (s0 + u < n_splits) o[k] = __fadd_rn(o[k], v[u][k]);
  }
#pragma unroll
  for (int k = 0; k < PER_THREAD; ++k) {
    const int e = tid + k * CONSUMERS;
    if (e < (int)part_elems)
      out[(size_t)(e / OUT_TILE) * out_dim + r0 + e % OUT_TILE] = o[k];
  }
}

template <int NT>
int launch(const void* x, const void* packed, const void* scale, void* out, void* parts,
           void* tickets, int R, int in_dim, int out_dim, int G, int half, int split,
           cudaStream_t stream) {
  const int n_splits = (G + split - 1) / split;
  const size_t smem = HEADER + (size_t)STAGES * (OUT_TILE * half + OUT_TILE * 2) +
                      (size_t)R * (split * 4 * half + X_PAD);
  // the limit is raised only when a launch needs more than any before it,
  // so a decode step pays no driver call (one card per process)
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        q4_matmul_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_allowed = smem;
  }
  q4_matmul_kernel<NT><<<dim3(n_splits, out_dim / OUT_TILE), THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const __nv_bfloat16*>(scale), static_cast<float*>(out),
      static_cast<float*>(parts), static_cast<int*>(tickets), R, in_dim, out_dim, G, half,
      split);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched). `rows` is the compiled row bucket
// (8, 16 or 32: K8_ROW_BUCKETS) with R <= rows; `split` the groups per split
// (k8_split). With more than one split, parts holds out/64 * splits * R * 64
// floats and tickets out/64 ints that are 0 on entry (and are 0 again on
// exit); with one, both may be null. Shapes are checked by the Python
// wrapper, and again here for what the kernel relies on.
extern "C" int lnb_q4_matmul(const void* x, const void* packed, const void* scale,
                             void* out, void* parts, void* tickets, int R, int rows,
                             int in_dim, int out_dim, int G, int half, int split,
                             void* stream) {
  const int n_splits = split < 1 ? 0 : (G + split - 1) / split;
  if (R < 1 || R > rows || half % PIECE || half > MAX_HALF || out_dim % OUT_TILE ||
      in_dim != G * 2 * half || split < 1 || split > G || R * split * 4 * half > X_BYTES ||
      (n_splits > 1 && (parts == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 8: return launch<1>(x, packed, scale, out, parts, tickets, R, in_dim, out_dim, G,
                             half, split, st);
    case 16: return launch<2>(x, packed, scale, out, parts, tickets, R, in_dim, out_dim, G,
                              half, split, st);
    case 32: return launch<4>(x, packed, scale, out, parts, tickets, R, in_dim, out_dim, G,
                              half, split, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
