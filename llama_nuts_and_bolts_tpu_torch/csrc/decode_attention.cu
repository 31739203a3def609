// K2 and K3: S=1 flash decode attention over a stacked KV cache (head_dim 128),
// bf16 (K2) or int8 with per-position bf16 scales (K3).
//
// Replaces the Pallas kernel llama_nuts_and_bolts_tpu/kernels/decode_attention.py
// (flash_decode_attention, blocked=True, fold_heads=False ->
// _decode_kernel_blocked) for a bf16 and an int8 cache. Batch row b attends
// cache slots t <= start_pos[b] of layer `layer` of a [L, B, KV, T, D] cache;
// keys past a row's position are never read. An int8 element is dequantized
// to bf16(bf16(int8) * bf16(scale[t])) as it is read, as the Pallas kernel
// does, so both caches reach the products as bf16 values. Online fp32
// softmax over 64-key tiles, the G query heads of one KV head sharing each
// tile, p rounded to bf16 before the PV product, masked scores at -1e30, l
// floored at 1e-30.
//
// What bounds it on the H100: bytes. Each visible cache row is read once
// (2 * KV * (pos + 1) * D bytes per call for int8, twice that for bf16, plus
// 4 bytes of scales per position and head for int8) against
// 4 * H * D * (pos + 1) FLOPs, about 2 FLOPs per byte -- far below the ~295
// FLOP/byte ridge. At B=1, T=4096, position 3000 the bound is 0.0037 ms.
//
// What replaced what. The first design ran one block per (KV head, batch
// row): 8 blocks on 132 SMs at B=1, each loading a tile synchronously and
// then crossing four barriers with no load in flight, about 2% of the
// card's memory rate: 0.1675 ms at B=1, T=4096, position 3000 (its last
// time, kept in PERF.md's kernel table; K3 0.2277 ms). This design:
//   * Grid (splits, KV, B): split s of row b covers keys [s * split_k,
//     (s + 1) * split_k). split_k is a function of T, B and KV only
//     (kernels/decode_attention.py::k2_split_k, about 256 blocks when every
//     split is active); positions stay on the card and a block whose split
//     starts past start_pos[b] exits at once, reading nothing.
//   * Each block streams its split through a ring of STAGES tiles in shared
//     memory with 16-byte cp.async copies, STAGES - 1 tiles ahead of the one
//     it computes on, so loads overlap the score and PV work.
//   * Scores and PV stay on CUDA cores: at 2 FLOPs per byte tensor cores
//     would not move the bound.
//   * No second launch combines the splits. Each split writes its fp32
//     (m, l, acc) to a workspace and draws a ticket from a per-(row, KV
//     head) counter; the block that draws the last ticket of the row's
//     active splits combines them in split order (m = max m_i, l = sum l_i
//     e^(m_i - m), out = sum acc_i e^(m_i - m) / max(l, 1e-30)) and resets
//     the counter to 0. A row with one active split writes its output
//     directly. The workspace and counters are the wrapper's, made once per
//     shape and stream, so two calls never share them at the same time.
//
// The tile, the split rule and the combine order are mirrored in
// kernels/decode_attention.py (K2_BLOCK_K, k2_split_k, k2_geometry,
// flash_decode_attention_plain). K4's bf16 and int8-dequantizing modes
// (fold_heads=True) and K5 launch this kernel too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;          // head_dim
constexpr int THREADS = 256;   // one (key, head) score and one (head, column pair) of PV each
constexpr int BLOCK_K = 64;     // cache positions per tile
constexpr int STAGES = 3;       // tiles in the shared-memory ring
constexpr int G = 4;            // query heads per KV head: Llama-3.1-8B's 32 / 8
constexpr int MAX_SPLITS = 256; // splits of a row (kernels/decode_attention.py: K2_MAX_SPLITS)
constexpr int SPLIT_LOADS = 32; // partials in flight per thread in the combine
constexpr float NEG_INF = -1e30f;

// One staged K or V tile: BLOCK_K rows of D cache elements, each row padded
// by 16 bytes, so that 8 threads reading 16 bytes of 8 consecutive rows hit
// 32 distinct banks.
template <typename CacheT>
struct Tile {
  static constexpr int ROW = D * (int)sizeof(CacheT) + 16;          // bytes
  static constexpr int BYTES = BLOCK_K * ROW;
  static constexpr int CHUNKS = D * (int)sizeof(CacheT) / 16;       // 16-byte chunks a row
  static constexpr int PER_CHUNK = 16 / (int)sizeof(CacheT);        // elements a chunk
};

// Copy 16 bytes from src (device memory) to dst (shared memory), both 16-byte
// aligned. With valid false nothing is read and dst is zero-filled, so a
// tile's rows past the visible keys hold zeros, never stale bits.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(n) : "memory");
}

// Close the group of copies issued since the last commit (an empty group
// when none were).
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A 16-byte chunk of a staged row as fp32: bf16 values as they are, int8
// values as bf16(float(int8) * scale), the bf16 product exactly rounded.
__device__ __forceinline__ void unpack(const uint4 raw, float, const __nv_bfloat16*,
                                       float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack(const uint4 raw, float s, const int8_t*, float* f) {
  const int8_t* e = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float2 x = __bfloat1622float2(
        __floats2bfloat162_rn((float)e[2 * i] * s, (float)e[2 * i + 1] * s));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// Two neighbouring cache elements of a staged row as fp32, as unpack reads them.
__device__ __forceinline__ float2 pair(const unsigned char* p, float, const __nv_bfloat16*) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 pair(const unsigned char* p, float s, const int8_t*) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return __bfloat1622float2(__floats2bfloat162_rn((float)c.x * s, (float)c.y * s));
}

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
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
                    float* __restrict__ part_acc,          // [B, KV, splits, G, D]
                    float* __restrict__ part_ml,           // [B, KV, splits, G, 2]
                    int* __restrict__ tickets,             // [B, KV], 0 between calls
                    int B, int H, int KV, int T, int layer, int split_k, float scale) {
  using TileT = Tile<CacheT>;
  constexpr bool INT8 = sizeof(CacheT) == 1;
  extern __shared__ __align__(16) unsigned char ring[];   // [STAGES][k, v][TileT::BYTES]
  __shared__ __align__(16) float qs[G][D];
  __shared__ __align__(16) float ps[BLOCK_K][G];         // scores, then p, of the tile
  __shared__ float vsc[BLOCK_K];                          // the tile's v scales (int8)
  __shared__ float m_s[G], l_s[G], corr_s[G];
  __shared__ bool last_s;

  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the row's q is read alongside its position, not after it
  static_assert(G * D == 2 * THREADS, "one bf16 pair of q per thread");
  const __nv_bfloat162 q2 = reinterpret_cast<const __nv_bfloat162*>(
      q + ((size_t)b * H + (size_t)kvh * G) * D)[tid];
  const int n_keys = max(0, min(start_pos[b] + 1, T));
  // split 0 always runs, so a row with no visible key still writes its zeros
  const int n_active = max(1, (n_keys + split_k - 1) / split_k);
  if (s >= n_active) return;
  const int k0 = s * split_k;
  const int k_end = min(k0 + split_k, n_keys);
  const int n_tiles = (max(k_end - k0, 0) + BLOCK_K - 1) / BLOCK_K;

  const size_t head = ((size_t)layer * B + b) * KV + kvh;
  const CacheT* kh = k + head * (size_t)T * D;
  const CacheT* vh = v + head * (size_t)T * D;

  // Tile i of the split into ring slot i % STAGES, rows past k_end zero-filled;
  // always closes a commit group, so every iteration waits on the same count.
  auto issue = [&](int i) {
    if (i < n_tiles) {
      unsigned char* kd = ring + (size_t)(i % STAGES) * 2 * TileT::BYTES;
      unsigned char* vd = kd + TileT::BYTES;
      const int t0 = k0 + i * BLOCK_K;
      for (int idx = tid; idx < BLOCK_K * TileT::CHUNKS; idx += THREADS) {
        const int r = idx / TileT::CHUNKS, c = idx % TileT::CHUNKS;
        const bool visible = t0 + r < k_end;
        const size_t off = visible ? (size_t)(t0 + r) * D + c * TileT::PER_CHUNK : 0;
        cp_async16(kd + r * TileT::ROW + c * 16, kh + off, visible);
        cp_async16(vd + r * TileT::ROW + c * 16, vh + off, visible);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);

  *reinterpret_cast<float2*>(&qs[0][0] + 2 * tid) = __bfloat1622float2(q2);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // Scores: warp w takes heads hp, hp + 1 (hp = 2 * (w / 4)) of 16 keys of
  // the tile; lanes l and l ^ 8 split one key's D in halves, so the 8 lanes
  // of a quarter warp read 8 rows at once without a bank conflict.
  const int hp = 2 * (warp >> 2);
  const int key = (warp & 3) * 16 + (lane >> 4) * 8 + (lane & 7);
  const int half = (lane >> 3) & 1;
  // PV: thread tid owns columns 2c, 2c + 1 of heads pv_h, pv_h + 1 over the
  // keys of one half of every tile; the halves are summed once, at the end
  const int c = tid & 63, pv_h = 2 * ((tid >> 6) & 1), kpart = tid >> 7;
  float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};         // [head pv_h + i][column 2c + j]

  // int8: the scales of this thread's key, one tile ahead of their use
  float sk = 0.f, sv = 0.f, sk_next = 0.f, sv_next = 0.f;
  auto scales = [&](int i) {
    const int t = k0 + i * BLOCK_K + key;
    const bool visible = i < n_tiles && t < k_end;
    sk_next = visible ? __bfloat162float(k_scale[head * T + t]) : 0.f;
    sv_next = visible ? __bfloat162float(v_scale[head * T + t]) : 0.f;
  };
  if constexpr (INT8) scales(0);

  for (int i = 0; i < n_tiles; ++i) {
    if constexpr (INT8) {
      sk = sk_next;
      sv = sv_next;
      scales(i + 1);
    }
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile i is staged; tile i-1's reads of its slot, ps, vsc are done
    issue(i + STAGES - 1);
    const unsigned char* kt = ring + (size_t)(i % STAGES) * 2 * TileT::BYTES;
    const unsigned char* vt = kt + TileT::BYTES;
    const int t0 = k0 + i * BLOCK_K;

    // scores: fp32 dots over this lane's half of D, two chains a head, then
    // the two halves added across lanes l and l ^ 8
    {
      constexpr int HALF = TileT::CHUNKS / 2;
      const unsigned char* krow = kt + key * TileT::ROW + half * HALF * 16;
      const float* q0 = qs[hp] + half * HALF * TileT::PER_CHUNK;
      const float* q1 = qs[hp + 1] + half * HALF * TileT::PER_CHUNK;
      float d[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int ch = 0; ch < HALF; ++ch) {
        float f[TileT::PER_CHUNK];
        unpack(*reinterpret_cast<const uint4*>(krow + ch * 16), sk,
               static_cast<const CacheT*>(nullptr), f);
#pragma unroll
        for (int e = 0; e < TileT::PER_CHUNK; ++e) {
          d[0][ch & 1] = fmaf(q0[ch * TileT::PER_CHUNK + e], f[e], d[0][ch & 1]);
          d[1][ch & 1] = fmaf(q1[ch * TileT::PER_CHUNK + e], f[e], d[1][ch & 1]);
        }
      }
      float s0 = d[0][0] + d[0][1], s1 = d[1][0] + d[1][1];
      s0 += __shfl_xor_sync(0xffffffffu, s0, 8);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 8);
      if (half == 0) {
        const bool visible = t0 + key < k_end;
        *reinterpret_cast<float2*>(&ps[key][hp]) =
            visible ? make_float2(s0 * scale, s1 * scale) : make_float2(NEG_INF, NEG_INF);
        if (INT8 && hp == 0) vsc[key] = sv;
      }
    }
    __syncthreads();

    // online softmax: one warp per head row, two positions per lane
    if (warp < G) {
      const int h = warp;
      const float s0 = ps[lane][h], s1 = ps[lane + 32][h];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[h];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // PV takes p rounded to bf16; l sums the fp32 values
      ps[lane][h] = __bfloat162float(__float2bfloat16(p0));
      ps[lane + 32][h] = __bfloat162float(__float2bfloat16(p1));
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[h] = corr;
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // PV over this thread's half of the keys, in two chains (even and odd
    // keys), then acc = acc * corr + sum
    {
      float pv[2][2][2] = {};                         // [chain][head][column]
      const unsigned char* vcol = vt + c * 2 * (int)sizeof(CacheT);
#pragma unroll 8
      for (int rr = 0; rr < BLOCK_K / 2; ++rr) {
        const int r = kpart * (BLOCK_K / 2) + rr;
        const float2 x = pair(vcol + r * TileT::ROW, INT8 ? vsc[r] : 0.f,
                              static_cast<const CacheT*>(nullptr));
        const float2 p = *reinterpret_cast<const float2*>(&ps[r][pv_h]);
        float (*ch)[2] = pv[rr & 1];
        ch[0][0] = fmaf(p.x, x.x, ch[0][0]);
        ch[0][1] = fmaf(p.x, x.y, ch[0][1]);
        ch[1][0] = fmaf(p.y, x.x, ch[1][0]);
        ch[1][1] = fmaf(p.y, x.y, ch[1][1]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float corr = corr_s[pv_h + h];
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[h][e] = fmaf(acc[h][e], corr, pv[0][h][e] + pv[1][h][e]);
      }
    }
  }
  __syncthreads();  // the row state is final (and set when the split had no tile)

  // the two key halves summed; thread tid then owns columns 2j, 2j + 1 of
  // head g for the output, the partial and the combine
  float* halves = reinterpret_cast<float*>(ring) + 2 * MAX_SPLITS * G;  // past the combine's
#pragma unroll
  for (int h = 0; h < 2; ++h)
    *reinterpret_cast<float2*>(halves + ((kpart * G + pv_h + h) * D + 2 * c)) =
        make_float2(acc[h][0], acc[h][1]);
  __syncthreads();
  const int j = tid & 63, g = tid >> 6;
  const float2 lo = *reinterpret_cast<const float2*>(halves + (g * D + 2 * j));
  const float2 hi = *reinterpret_cast<const float2*>(halves + ((G + g) * D + 2 * j));
  const float a0 = lo.x + hi.x, a1 = lo.y + hi.y;

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
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tickets[row], 1) == n_active - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid == 0) tickets[row] = 0;

  // The combine, in as few L2 round trips as it can: this thread's first
  // SPLIT_LOADS partial outputs are requested first, then every split's
  // (m, l) comes into shared memory at once; per head, one warp takes
  // m = max m_i, the weights w_i = e^(m_i - m) and l = sum l_i w_i in split
  // order; then each thread sums its outputs over the splits in order.
  const float* pa_row = part_acc + row * n_splits * G * D + g * D + 2 * j;
  const float* pm_row = part_ml + row * n_splits * G * 2;
  float2 x[SPLIT_LOADS];
#pragma unroll
  for (int u = 0; u < SPLIT_LOADS; ++u)
    if (u < n_active) x[u] = __ldcg(reinterpret_cast<const float2*>(pa_row + u * G * D));
  float* w_s = reinterpret_cast<float*>(ring);           // the ring is idle now
  float* lp_s = w_s + MAX_SPLITS * G;
  for (int e = tid; e < n_active * G; e += THREADS) {
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(pm_row) + e);
    w_s[e] = ml.x;
    lp_s[e] = ml.y;
  }
  __syncthreads();
  if (warp < G) {
    const int h = warp;
    float m = NEG_INF;
    for (int i = lane; i < n_active; i += 32) m = fmaxf(m, w_s[i * G + h]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    for (int i = lane; i < n_active; i += 32) w_s[i * G + h] = expf(w_s[i * G + h] - m);
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int i = 0; i < n_active; ++i) l += lp_s[i * G + h] * w_s[i * G + h];
      l_s[h] = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();
  float o0 = 0.f, o1 = 0.f;
  for (int i0 = 0; i0 < n_active; i0 += SPLIT_LOADS) {
    if (i0 > 0) {
#pragma unroll
      for (int u = 0; u < SPLIT_LOADS; ++u)
        if (i0 + u < n_active)
          x[u] = __ldcg(reinterpret_cast<const float2*>(pa_row + (i0 + u) * G * D));
    }
#pragma unroll
    for (int u = 0; u < SPLIT_LOADS; ++u) {
      if (i0 + u < n_active) {
        const float w = w_s[(i0 + u) * G + g];
        o0 += x[u].x * w;
        o1 += x[u].y * w;
      }
    }
  }
  store2(oh + g * D, o0 / l_s[g], o1 / l_s[g]);
}

template <typename CacheT>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* start_pos, void* out, void* part_acc,
           void* part_ml, void* tickets, int B, int H, int KV, int T, int layer,
           int split_k, float scale, void* stream) {
  const int n_splits = (T + split_k - 1) / split_k;
  if (H != KV * G || split_k < BLOCK_K || split_k % BLOCK_K || n_splits > MAX_SPLITS)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = STAGES * 2 * Tile<CacheT>::BYTES;
  static_assert((2 * MAX_SPLITS * G + 2 * G * D) * sizeof(float) <= smem,
                "the halves and the combine reuse the ring");
  // above 48 KB a kernel needs its limit raised, once per process (one card)
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<CacheT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  dim3 grid(n_splits, KV, B);
  flash_decode_kernel<CacheT><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CacheT*>(k),
      static_cast<const CacheT*>(v), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(start_pos),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(tickets), B, H, KV, T, layer,
      split_k, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns a cudaError_t (0 = launched). Shapes are checked by the Python
// wrapper; H / KV must be G and split_k a multiple of the 64-key tile.
// part_acc holds B * KV * splits * G * D floats, part_ml B * KV * splits * G * 2,
// tickets B * KV ints that are 0 on entry (and are 0 again on exit).
extern "C" int lnb_flash_decode_attention(const void* q, const void* k,
                                          const void* v, const void* start_pos,
                                          void* out, void* part_acc, void* part_ml,
                                          void* tickets, int B, int H, int KV, int T,
                                          int layer, int split_k, float scale,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k, v, nullptr, nullptr, start_pos, out, part_acc,
                               part_ml, tickets, B, H, KV, T, layer, split_k, scale,
                               stream);
}

extern "C" int lnb_flash_decode_attention_q8(const void* q, const void* k,
                                             const void* v, const void* k_scale,
                                             const void* v_scale,
                                             const void* start_pos, void* out,
                                             void* part_acc, void* part_ml,
                                             void* tickets, int B, int H, int KV,
                                             int T, int layer, int split_k,
                                             float scale, void* stream) {
  return launch<int8_t>(q, k, v, k_scale, v_scale, start_pos, out, part_acc, part_ml,
                        tickets, B, H, KV, T, layer, split_k, scale, stream);
}
