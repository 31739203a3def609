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
// KV = 8, D = 128, T >= 2048); the quantization row may not shrink.
//
// What bounds it on the H100: bytes. Each visible int8 cache row is read
// once, with 4 bytes of scales per position and head: 2 * KV * (pos + 1) *
// (D + 2) bytes per call against 4 * H * D * (pos + 1) integer operations,
// about one operation per byte -- no work for tensor cores (and G = 4 would
// fill 4 of the 16 rows of an mma.sync m16n8k32).
//
// What the design does about it: a thread-block cluster splits every tile.
// A cluster of C blocks (kernels/decode_attention.py::k4_cluster, from the
// shapes alone: C * B * KV >= 64 blocks with 256 keys a rank at least, so a
// 2048-key tile at B=1 takes 8 and a 256-key tile 1) serves one (KV head,
// batch row); rank r owns keys [t0 + r * chunk, t0 + (r + 1) * chunk) of
// each tile, chunk = block_k / C. The tiles run in the reference's order, so
// the running m and the quantization rows stay the JAX tile's:
//   * Loads: a rank's k rows, v rows and bf16 scales are contiguous in the
//     stacked cache. Thread 0 streams them in pieces of at most 256 keys with
//     1-D bulk async copies (cp.async.bulk, no tensor map) into a ring of
//     stages under mbarriers, only the visible keys (scales rounded up to
//     the copy's 16 bytes), in the order they are used: per tile the k
//     pieces (with both scales), then the v pieces. Every stage the ring
//     holds is issued first thing (at C = 8, T = 4096 that is all of the
//     block's bytes), while warps 1-4 quantize q; a stage is refilled once
//     the block has read it, so v's copies and the next tile's run under the
//     scores and the exchanges. At C = 1 a 2048-key tile streams through 4.
//   * Scores: 8 lanes a key, lane (h, g) q row g over the row's 64-byte half
//     h, that half of q held in registers; a quarter warp reads one 128-byte
//     row (no bank conflict); __dp4a, then one shuffle adds the halves.
//   * The two tile-wide reductions cross the cluster point to point: every
//     warp pushes its row maxima into a slot of every rank with st.async,
//     which counts the bytes on the receiver's mbarrier; each rank waits for
//     its C x 8 slots and reduces them, in rank order, to the same m_new.
//     Then each warp's sum of p and max |p * vs| the same way, so every rank
//     holds the tile's ps (a max: exact) and l's increment (per warp the
//     ranks in rank order, then the warps in a fixed tree; only the fp32
//     order of l's sum over keys differs from the reference).
//   * From p on, the keys of 4-key group c are warp c % 8's: it computes
//     their p, quantizes them with the tile's ps and runs their PV, so none
//     of it waits for the block. PV: a lane per 4 columns, 4 rows of v
//     transposed in registers (__byte_perm) so each __dp4a multiplies 4
//     positions of p_i by 4 of v; the warps' int32 partials are summed in
//     shared memory and added into rank 0's by red.async, counted on its
//     mbarrier. Integer sums are exact, so their order does not matter.
//   * No cluster barrier in the loop. One split barrier at the start (a
//     relaxed arrival after the mbarriers are set, the wait before the first
//     push) makes sure every block runs before another writes to it. The
//     slots are safe to reuse: a rank pushes tile i + 1's maxima only after
//     every rank's tile-i sums arrived, which each sends only after reading
//     tile i's maxima (and the same for the sums). Rank 0 folds tile i's
//     int32 sum into its fp32 acc (acc * corr + sum * ps) once its mbarrier
//     counts every active rank's adds, before it sends tile i + 1's sums, so
//     no add of tile i + 1 comes first. A rank whose keys all lie past the
//     position still pushes its slots (the rows of a cluster share one
//     position, so one tile count). A rank leaves once its last exchange has
//     arrived: nothing more is written to it; rank 0 leaves last.
//   * A cluster of one keeps its slots local and synchronises its threads.
// Two calls on the same inputs give the same bits: every float sum has a
// fixed order. Constants mirrored in kernels/decode_attention.py (K4_*).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;          // head_dim
constexpr int G = 4;            // query heads per KV head: Llama-3.1-8B's 32 / 8
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int PIECE = 256;      // keys of one bulk-copied piece, at most
constexpr int MAX_STAGES = 8;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use (227 KB)
constexpr float NEG_INF = -1e30f;

// the fixed part of the shared-memory layout, in bytes (all 16-byte aligned)
constexpr int OFF_QW = 128;              // mbarriers before it: the ring's, then 3
constexpr int OFF_XMAX = OFF_QW + G * D;                     // q_i: int8 [G][D]
constexpr int OFF_XSUM = OFF_XMAX + MAX_CLUSTER * WARPS * G * 4;      // [rank][warp][G]
constexpr int OFF_QSC = OFF_XSUM + MAX_CLUSTER * WARPS * 2 * G * 4;   // [rank][warp][2G]
constexpr int OFF_TOT = OFF_QSC + G * 4;                     // qs * scale [G]
constexpr int OFF_PART = OFF_TOT + G * D * 4;                // int32 [G][D]
constexpr int OFF_CHUNK = OFF_PART + WARPS * G * D * 4;      // int32 [WARPS][G][D]

struct Layout {
  int chunk, chunk_pad, piece, pieces, stages, stage_bytes, ring, smem;
};

// chunk_pad is 8 past a multiple of 32: the G rows of s_f start 8 banks
// apart (the p loop's lanes read 4 rows of 4 keys at once), and every array
// after them stays 16-byte aligned
__host__ __device__ inline Layout layout(int T, int block_k, int cluster) {
  Layout s;
  s.chunk = block_k / cluster;
  s.chunk_pad = ((s.chunk + 31) & ~31) + 8;
  s.piece = s.chunk < PIECE ? s.chunk : PIECE;
  s.pieces = (s.chunk + s.piece - 1) / s.piece;                // per kind and tile
  s.stage_bytes = (s.piece * (D + 4) + 127) & ~127;           // k or v rows, 2 scales
  const int fixed = OFF_CHUNK + s.chunk_pad * (G * 4 + G + 4);  // s_f, p_i, vsc
  const int most = (T / block_k) * 2 * s.pieces;                // every key visible
  int fit = (SMEM_MAX - fixed) / s.stage_bytes;
  s.stages = most < MAX_STAGES ? most : MAX_STAGES;
  if (fit < s.stages) s.stages = fit;
  s.ring = fixed;
  s.smem = fixed + s.stages * s.stage_bytes;
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

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// the same, acquiring what other blocks of the cluster wrote (st.async, red.async)
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// the two halves of a cluster barrier, for work to run between them. The
// arrival is relaxed: what it publishes, the mbarriers' initialisation, is
// ordered by fence.mbarrier_init.release.cluster (a releasing arrival would
// wait for the block's copies in flight)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of p's counterpart in the shared memory of cluster rank r
__device__ __forceinline__ uint32_t mapa(const void* p, int r) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_u32(p)), "r"(r));
  return out;
}

// 16 bytes into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void st_async(uint32_t dst, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}

// an integer add into another block's shared memory, counted on its mbarrier
__device__ __forceinline__ void red_async_add(uint32_t dst, int v, uint32_t bar) {
  asm volatile(
      "red.async.relaxed.cluster.shared::cluster.mbarrier::complete_tx::bytes.add.u32 "
      "[%0], %1, [%2];\n" ::"r"(dst), "r"(v), "r"(bar) : "memory");
}

__device__ __forceinline__ float4 gather4(float x, int stride) {
  return make_float4(__shfl_sync(0xffffffffu, x, 0), __shfl_sync(0xffffffffu, x, stride),
                     __shfl_sync(0xffffffffu, x, 2 * stride),
                     __shfl_sync(0xffffffffu, x, 3 * stride));
}

// bytes (a multiple of 16) from src to dst, both 16-byte aligned, reported to bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// The visible keys of piece p of a rank's chunk that holds nv of them.
__device__ __forceinline__ int piece_keys(int nv, int p, int piece) {
  return max(0, min(piece, nv - p * piece));
}

// Thread 0's copy queue: (tile, kind, piece) in the order the block reads
// them, pieces without visible keys left out; stage n % stages, in turn.
struct Producer {
  int tile, kind, p, issued;
};

struct Cache {
  const int8_t* k;                 // this (layer, row, head)'s [T, D] rows
  const int8_t* v;
  const __nv_bfloat16* ks;         // its [T] scales
  const __nv_bfloat16* vs;
};

// Issue the next piece into its stage; returns false when none is left.
__device__ bool issue_next(Producer& pr, const Cache& c, const Layout& s, int n_keys,
                           int n_tiles, int block_k, int rank, uint8_t* ring,
                           uint64_t* full) {
  while (pr.tile < n_tiles) {
    const int base = pr.tile * block_k + rank * s.chunk;
    const int nv = max(0, min(s.chunk, n_keys - base));
    const int n = piece_keys(nv, pr.p, s.piece);
    const int key = base + pr.p * s.piece;
    const int kind = pr.kind;
    if (++pr.p == s.pieces || n == 0) {
      pr.p = 0;
      if (++pr.kind == 2) {
        pr.kind = 0;
        ++pr.tile;
      }
    }
    if (n == 0) continue;
    const int stage = pr.issued % s.stages;
    uint8_t* st = ring + stage * s.stage_bytes;
    const uint32_t rows = (uint32_t)n * D;
    if (kind == 0) {
      const uint32_t sb = (uint32_t)((n + 7) & ~7) * 2;     // whole 16-byte units
      mbar_expect_tx(&full[stage], rows + 2 * sb);
      bulk_load(st, c.k + (size_t)key * D, rows, &full[stage]);
      bulk_load(st + s.piece * D, c.ks + key, sb, &full[stage]);
      bulk_load(st + s.piece * (D + 2), c.vs + key, sb, &full[stage]);
    } else {
      mbar_expect_tx(&full[stage], rows);
      bulk_load(st, c.v + (size_t)key * D, rows, &full[stage]);
    }
    ++pr.issued;
    return true;
  }
  return false;
}

// Scores of the n visible keys of one k piece (chunk offset j0), 8 lanes a
// key: lane u takes q row g = u & 3 over the key's 64-byte half h = u >> 2,
// against q_r, that half of row g held in registers. A quarter warp is one
// key (two 64-byte reads, no bank conflict); one shuffle adds the halves, and
// lane g writes s_f[g][j] = float(q_i[g] . k_i[j]) * qsc[g] * ks[j] (lane 0
// vsc[j] = vs[j]); lmax takes row g's maxima. The loop is uniform over the
// block, so every lane of a warp reaches every shuffle.
__device__ __forceinline__ void score_piece(const uint8_t* st, int n, int j0,
                                            const Layout& s, const int4 (&q_r)[4],
                                            float qsc_g, float* s_f, float* vsc,
                                            float& lmax) {
  const int tid = threadIdx.x, u = tid & 7, g = u & 3, h = u >> 2;
  const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(st + s.piece * D);
  const __nv_bfloat16* vs = ks + s.piece;
#pragma unroll 2
  for (int base = 0; base < n; base += THREADS / 8) {
    const int j = base + tid / 8;
    const bool ok = j < n;
    int d0 = 0, d1 = 0;
    if (ok) {
      const int4* kr = reinterpret_cast<const int4*>(st + (size_t)j * D) + 4 * h;
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        const int4 ka = kr[i], kb = kr[i + 1];
        d0 = __dp4a(ka.x, q_r[i].x, d0);
        d0 = __dp4a(ka.y, q_r[i].y, d0);
        d0 = __dp4a(ka.z, q_r[i].z, d0);
        d0 = __dp4a(ka.w, q_r[i].w, d0);
        d1 = __dp4a(kb.x, q_r[i + 1].x, d1);
        d1 = __dp4a(kb.y, q_r[i + 1].y, d1);
        d1 = __dp4a(kb.z, q_r[i + 1].z, d1);
        d1 = __dp4a(kb.w, q_r[i + 1].w, d1);
      }
    }
    int dot = d0 + d1;
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    if (ok && h == 0) {
      const float x = __fmul_rn(__fmul_rn((float)dot, qsc_g), __bfloat162float(ks[j]));
      s_f[g * s.chunk_pad + j0 + j] = x;
      lmax = fmaxf(lmax, x);
      if (u == 0) vsc[j0 + j] = __bfloat162float(vs[j]);
    }
  }
}

__device__ __forceinline__ float pick(const float (&x)[G], int g) {
  return g == 0 ? x[0] : g == 1 ? x[1] : g == 2 ? x[2] : x[3];
}

// A tile's int32 PV sum into the fp32 acc: acc * corr + float(sum) * ps.
__device__ __forceinline__ float folded(float acc, int sum, float corr, float ps) {
  return __fadd_rn(__fmul_rn(acc, corr), __fmul_rn((float)sum, ps));
}

// Rank 0: the outputs tid and tid + THREADS of the [G, D] block folded with
// the tile's sum in tot, and tot back to zero for the next tile.
__device__ __forceinline__ void fold(int* tot, float (&acc)[2], const float (&corr)[G],
                                     const float (&ps)[G]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = threadIdx.x + i * THREADS, g = o / D;
    acc[i] = folded(acc[i], tot[o], pick(corr, g), pick(ps, g));
    tot[o] = 0;
  }
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
  extern __shared__ __align__(128) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x, rank = (int)cluster.block_rank();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout s = layout(T, block_k, C);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);            // the ring's stages
  uint64_t* xbar = full + MAX_STAGES;       // maxima, sums, rank 0's PV sum arrived
  const int4* q_w = reinterpret_cast<const int4*>(smem + OFF_QW);   // [G][8]
  float* xmax = reinterpret_cast<float*>(smem + OFF_XMAX);         // every rank's
  float* xsum = reinterpret_cast<float*>(smem + OFF_XSUM);         // warp partials
  float* qsc = reinterpret_cast<float*>(smem + OFF_QSC);
  int* tot = reinterpret_cast<int*>(smem + OFF_TOT);               // rank 0's [G][D]
  int* part = reinterpret_cast<int*>(smem + OFF_PART);             // [WARPS][G][D]
  float* s_f = reinterpret_cast<float*>(smem + OFF_CHUNK);         // [G][chunk_pad]
  int8_t* p_i = reinterpret_cast<int8_t*>(s_f + G * s.chunk_pad);  // [G][chunk_pad]
  float* vsc = reinterpret_cast<float*>(p_i + G * s.chunk_pad);    // [chunk_pad]
  uint8_t* ring = smem + s.ring;
  const int cp = s.chunk_pad;

  const int pos = start_pos[b];
  const int n_keys = min(pos + 1, T);
  const int n_tiles = n_keys > 0 ? (n_keys + block_k - 1) / block_k : 0;
  const size_t head = ((size_t)layer * B + b) * KV + kvh;
  const Cache c{k + head * (size_t)T * D, v + head * (size_t)T * D, k_scale + head * T,
                v_scale + head * T};
  auto rank_keys = [&](int kt, int r) {
    return max(0, min(s.chunk, n_keys - (kt * block_k + r * s.chunk)));
  };
  // ranks holding keys of tile kt: their PV sums are what rank 0 waits for
  auto active = [&](int kt) { return min(C, (n_keys - kt * block_k + s.chunk - 1) / s.chunk); };
  int pieces = 0;                             // this rank reads, k and v
  for (int kt = 0; kt < n_tiles; ++kt)
    pieces += 2 * ((rank_keys(kt, rank) + s.piece - 1) / s.piece);

  // thread 0 starts the copies first, so they run under everything else
  Producer pr{0, 0, 0, 0};
  if (tid == 0) {
    for (int i = 0; i < s.stages; ++i) mbar_init(&full[i], 1);
    for (int i = 0; i < 3; ++i) mbar_init(&xbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < s.stages; ++i)
      if (!issue_next(pr, c, s, n_keys, n_tiles, block_k, rank, ring, full)) break;
    if (C > 1 && rank == 0 && n_tiles > 0) mbar_expect_tx(&xbar[2], active(0) * G * D * 4);
  }
  // quantize the G query rows, beside thread 0's copies: warp 1 + g owns
  // row g, 4 columns per lane
  if (warp >= 1 && warp <= G) {
    const int g = warp - 1;
    const __nv_bfloat16* qrow = q + ((size_t)b * H + (size_t)kvh * G + g) * D;
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
    reinterpret_cast<uint32_t*>(smem + OFF_QW)[g * (D / 4) + lane] = packed;
    if (lane == 0) qsc[g] = qs * scale;
  }
  if (C > 1)
    for (int o = tid; o < G * D; o += THREADS) tot[o] = 0;
  __syncthreads();
  // every block of the cluster runs, its barriers set, before another
  // writes to it: arrive now, wait before the first write
  if (C > 1) cluster_arrive();

  // a stage is refilled once every warp has read it, if a piece is left
  int consumed = 0;
  auto release = [&]() {
    if (consumed + s.stages < pieces) {
      __syncthreads();
      if (tid == 0) issue_next(pr, c, s, n_keys, n_tiles, block_k, rank, ring, full);
    }
    ++consumed;
  };

  int4 q_r[4];                                // the lane's half of its q row
#pragma unroll
  for (int i = 0; i < 4; ++i) q_r[i] = q_w[(lane & 3) * 8 + 4 * ((lane >> 2) & 1) + i];
  const float qsc_g = qsc[lane & 3];
  float m_run[G], l_run[G], corr_prev[G], ps_prev[G], acc[2] = {0.f, 0.f};
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m_run[g] = NEG_INF;
    l_run[g] = 0.f;
    corr_prev[g] = ps_prev[g] = 0.f;
  }
  // from the scores on, the keys 4c .. 4c + 3 of a chunk are warp c % 8's:
  // lane (half, row, k4) takes key 4 (c + 8 * half) + k4 of row ro
  const int k4 = lane & 3, ro = (lane >> 2) & 3, half = lane >> 4;
  const int sw = lane >> 2, sg = lane & 3;    // the partials a lane reads: (warp, row)

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int nv = rank_keys(kt, rank);
    const int np = (nv + s.piece - 1) / s.piece;
    if (C > 1 && tid == 0) {                  // this tile's exchanges into this block
      mbar_expect_tx(&xbar[0], C * WARPS * 16);
      mbar_expect_tx(&xbar[1], C * WARPS * 32);
    }

    // scores of the rank's keys, piece by piece as they arrive
    float lmax = NEG_INF;                     // of row lane & 3
    for (int p = 0; p < np; ++p) {
      const int stage = consumed % s.stages;
      mbar_wait(&full[stage], (consumed / s.stages) & 1);
      score_piece(ring + stage * s.stage_bytes, piece_keys(nv, p, s.piece), p * s.piece, s,
                  q_r, qsc_g, s_f, vsc, lmax);
      release();
    }

    // the tile's row maxima: each warp's into every rank, read back here
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      lmax = fmaxf(lmax, __shfl_xor_sync(0xffffffffu, lmax, off));
    {
      const float4 v4 = gather4(lmax, 1);
      float* mine = xmax + (rank * WARPS + warp) * G;
      if (C == 1) {
        if (lane == 0) *reinterpret_cast<float4*>(mine) = v4;
        __syncthreads();
      } else {
        if (kt == 0) cluster_wait();
        if (lane < C) st_async(mapa(mine, lane), v4, mapa(&xbar[0], lane));
        mbar_wait_cluster(&xbar[0], kt & 1);
      }
    }
    if (C > 1 && rank == 0 && kt > 0) {       // tile kt - 1's PV sum is in
      mbar_wait_cluster(&xbar[2], (kt - 1) & 1);
      fold(tot, acc, corr_prev, ps_prev);
      if (tid == 0) mbar_expect_tx(&xbar[2], active(kt) * G * D * 4);
    }
    float m_new[G];
    {
      float x = pick(m_run, sg);
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < C) x = fmaxf(x, xmax[(r * WARPS + sw) * G + sg]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
#pragma unroll
      for (int g = 0; g < G; ++g) m_new[g] = __shfl_sync(0xffffffffu, x, g);
    }

    // p and p * vs of the warp's keys, their sum and max |p * vs| the same way
    const float m_ro = pick(m_new, ro);
    float lsum = 0.f, pmax = 0.f;
#pragma unroll 2
    for (int c4 = warp + 8 * half; 4 * c4 < nv; c4 += 16) {
      const int j = 4 * c4 + k4;
      if (j < nv) {
        const float p = expf(s_f[ro * cp + j] - m_ro);
        const float pf = __fmul_rn(p, vsc[j]);
        s_f[ro * cp + j] = pf;
        lsum += p;
        pmax = fmaxf(pmax, fabsf(pf));
      }
    }
#pragma unroll
    for (int off = 1; off <= 16; off *= 2) {
      if (off == 4 || off == 8) continue;     // lanes of other rows
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
    }
    {
      const float4 s4 = gather4(lsum, 4), p4 = gather4(pmax, 4);
      float* mine = xsum + (rank * WARPS + warp) * 2 * G;
      if (C == 1) {
        if (lane == 0) {
          reinterpret_cast<float4*>(mine)[0] = s4;
          reinterpret_cast<float4*>(mine)[1] = p4;
        }
        __syncthreads();
      } else {
        if (lane < C) {
          st_async(mapa(mine, lane), s4, mapa(&xbar[1], lane));
          st_async(mapa(mine + G, lane), p4, mapa(&xbar[1], lane));
        }
        mbar_wait_cluster(&xbar[1], kt & 1);
      }
    }
    float ps[G];
    {
      // per (warp, row) the ranks in rank order, then the warps in a fixed
      // tree: the same sum on every rank
      float top = 0.f, sum = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < C) {
          const float* x = xsum + (r * WARPS + sw) * 2 * G;
          top = fmaxf(top, x[G + sg]);
          sum = __fadd_rn(sum, x[sg]);
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, off));
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ps[g] = fmaxf(__shfl_sync(0xffffffffu, top, g), 1e-30f) / 127.0f;
        const float corr = expf(m_run[g] - m_new[g]);
        l_run[g] = __fadd_rn(__fmul_rn(l_run[g], corr), __shfl_sync(0xffffffffu, sum, g));
        m_run[g] = m_new[g];
        corr_prev[g] = corr;
        ps_prev[g] = ps[g];
      }
    }
    if (nv == 0) continue;                    // uniform over the block

    // p_i of the warp's keys with the tile's scale, zero past the visible
    // ones, read back by the same warp's PV
    const float ps_ro = pick(ps, ro);
#pragma unroll 2
    for (int c4 = warp + 8 * half; 4 * c4 < nv; c4 += 16) {
      const int j = 4 * c4 + k4;
      p_i[ro * cp + j] = j < nv ? (int8_t)clip127(s_f[ro * cp + j] / ps_ro) : 0;
    }
    __syncwarp();

    // PV: warp = 4-key slice, lane = columns 4*lane .. 4*lane+3
    int pacc[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) pacc[g][i] = 0;
    for (int p = 0; p < np; ++p) {
      const int stage = consumed % s.stages;
      mbar_wait(&full[stage], (consumed / s.stages) & 1);
      const int8_t* st = reinterpret_cast<const int8_t*>(ring + stage * s.stage_bytes);
      const int n = piece_keys(nv, p, s.piece), j0 = p * s.piece;
#pragma unroll 2
      for (int ch = warp; 4 * ch < n; ch += WARPS) {
        const int r0 = 4 * ch;
        int w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = r0 + i < n ? *reinterpret_cast<const int*>(st + (r0 + i) * D + 4 * lane) : 0;
        // w[i] holds v[r0+i][4*lane .. +3]; x[c] gets v[r0 .. r0+3][4*lane + c]
        const int lo01 = __byte_perm(w[0], w[1], 0x5140), hi01 = __byte_perm(w[0], w[1], 0x7362);
        const int lo23 = __byte_perm(w[2], w[3], 0x5140), hi23 = __byte_perm(w[2], w[3], 0x7362);
        const int x[4] = {(int)__byte_perm(lo01, lo23, 0x5410),
                          (int)__byte_perm(lo01, lo23, 0x7632),
                          (int)__byte_perm(hi01, hi23, 0x5410),
                          (int)__byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int pw = *reinterpret_cast<const int*>(p_i + g * cp + j0 + r0);
#pragma unroll
          for (int i = 0; i < 4; ++i) pacc[g][i] = __dp4a(pw, x[i], pacc[g][i]);
        }
      }
      release();
    }
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[(warp * G + g) * D + 4 * lane + i] = pacc[g][i];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = tid + i * THREADS;
      int sum = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += part[w * G * D + o];
      if (C == 1)                             // the whole tile's sum: fold it now
        acc[i] = folded(acc[i], sum, pick(corr_prev, o / D), pick(ps_prev, o / D));
      else
        red_async_add(mapa(tot + o, 0), sum, mapa(&xbar[2], 0));
    }
  }
  if (C > 1) {
    // a rank leaving here has received its last exchange: nothing more is
    // written to it. Rank 0 first waits for the last tile's PV sums.
    if (n_tiles == 0) cluster_wait();
    if (rank != 0) return;
    if (n_tiles > 0) {
      mbar_wait_cluster(&xbar[2], (n_tiles - 1) & 1);
      fold(tot, acc, corr_prev, ps_prev);
    }
  }
  __nv_bfloat16* oh = out + ((size_t)b * H + (size_t)kvh * G) * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = tid + i * THREADS;
    oh[o] = __float2bfloat16(acc[i] / fmaxf(pick(l_run, o / D), 1e-30f));
  }
}

bool cluster_takes(int block_k, int cluster) {
  if (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8 && cluster != 16)
    return false;
  const int chunk = block_k / cluster;
  return block_k % cluster == 0 && chunk % 8 == 0 && (cluster == 1 || chunk >= 16);
}

// The launch configuration, with the kernel's attributes raised as far as
// it needs (once per process: a decode step pays no driver call).
cudaError_t configure(int T, int block_k, int cluster, cudaLaunchConfig_t& cfg,
                      cudaLaunchAttribute& attr) {
  const Layout s = layout(T, block_k, cluster);
  if (s.stages < 1) return cudaErrorInvalidValue;
  static int smem_allowed = 48 * 1024;
  static bool non_portable = false;
  if (s.smem > smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_dot_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, s.smem);
    if (err != cudaSuccess) return err;
    smem_allowed = s.smem;
  }
  if (cluster > 8 && !non_portable) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_dot_decode_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  cfg = cudaLaunchConfig_t{};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = s.smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

}  // namespace

// Returns a cudaError_t (0 = launched). Shapes are checked by the Python
// wrapper; H / KV must be G, T a multiple of block_k, and the cluster one
// that cuts block_k into chunks of whole 8-key units, 16 keys at least
// (kernels/decode_attention.py::k4_cluster picks it).
extern "C" int lnb_flash_decode_int8_mxu(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* start_pos, void* out, int B,
                                         int H, int KV, int T, int layer, int block_k,
                                         int cluster, float scale, void* stream) {
  if (H != KV * G || block_k < 1 || T % block_k || !cluster_takes(block_k, cluster))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(T, block_k, cluster, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(cluster, KV, B);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(
      &cfg, int8_dot_decode_kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(k), static_cast<const int8_t*>(v),
      static_cast<const __nv_bfloat16*>(k_scale), static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(start_pos), static_cast<__nv_bfloat16*>(out), B, H, KV, T,
      layer, block_k, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of this launch the card holds at once
// (cudaOccupancyMaxActiveClusters), into *n; kernels/k4_clusters.py reads it.
extern "C" int lnb_k4_max_active_clusters(int T, int block_k, int cluster, int* n) {
  if (!cluster_takes(block_k, cluster)) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(T, block_k, cluster, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  cfg.gridDim = dim3(cluster, 1, 1);
  return (int)cudaOccupancyMaxActiveClusters(n, int8_dot_decode_kernel, &cfg);
}
