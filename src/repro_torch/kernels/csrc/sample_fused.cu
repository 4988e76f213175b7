// Exact three-branch topic draw for LDA tokens, one warp per run of tokens
// (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/sample_fused.py, which
// share one body (_phase_body :68-140):
//   sample_fused        (def :202, pallas_call :234) -> sample_fused_launch
//   sample_fused_tiled  (def :251, pallas_call :304) -> sample_fused_tiled_launch
// Per token t with rows d = D[doc[t]] (int32, K) and w = W_hat[v] (float32,
// K), v = word[t], and the word's stats K1 = k1_w[v] (first index of max w),
// a1 = a1_w[v] (= w[K1]) and Q' = q_w[v] (= alpha*(sum_k w[k] - a1)):
//
//   b1 = d[K1],  M = a1*(b1+alpha),  S' = sum_k d[k]*w[k] - a1*b1
//   x  = u*(M+S'+Q')
//   topic = K1 if x < M, else the first k != K1 whose running sum of
//           (d[k]+alpha)*w[k] exceeds x-M, else K-1 (float undershoot).
//
// Outputs (topic, M, S', Q'). The Pallas kernel takes rows gathered by
// XLA and derives K1, a1 and sum w from them; here the kernel gathers its
// own rows by doc and word id (a pre-gathered (N, K) pair would not fit on
// the card at 100 M tokens) and takes the per-word stats the iteration
// already holds (core/three_branch.py word_stats), so a token reads each
// row once and does no argmax and no sum of w.
//
// The tiled variant reads the W_hat row and the stats through its tile's
// word window, as the Pallas kernel does: token t lies in tile
// t / tile_size, whose window starts at base = clip(tile_first[tile], 0,
// V - win), and its row is base + clip(word[t] - base, 0, win - 1). For
// every token of a tile whose word run fits the window (the caller routes
// only such tiles here) that is word[t] itself, so the two variants read
// the same values through the same code and are bitwise equal. The window
// is read from global memory (through L2).
//
// Bound: bytes. Each token needs its D row and its W_hat row (K*8 bytes;
// at most N*K*8 bytes in all, less where tokens share rows) plus 28 bytes
// of its own and 12 of its word's stats. The arithmetic is ~7 flops per
// topic, under the byte rate's 20 flops per byte.
//
// Design: a warp draws a run of kRun consecutive tokens. It stages each
// token's D and W_hat rows in its own shared memory with coalesced
// 16-byte loads (4 whole 128-byte lines an instruction) and reloads a row
// only when the token's doc or word differs from the last one's: tokens
// in T order share their word, tokens in doc-major order their doc, so
// one of the two rows comes once per run of the id. While it draws one
// token the warp already holds the next token's ids and stats, and (K <=
// 1024 with 16-byte rows) has that token's changing row in flight into
// registers, stored to shared memory once the draw is done: the load
// latency of a token overlaps the previous token's arithmetic.
// Lane j owns the contiguous block of `chunk` topics starting at j*chunk
// (chunk = ceil(K/32), rounded up to 4 when the rows allow 16-byte
// loads); the staged rows are padded 16 bytes every 128 so that the
// lanes' blocks lie in distinct banks. In one pass over its block a lane
// sums d*w (for S') and the live mass (d+alpha)*w over k != K1. One warp
// reduction gives S', one 5-step warp scan of the lane totals finds the
// lane whose block crosses x-M, and that lane walks its block in topic
// order. Its running sum in the walk repeats its total's additions
// exactly, so the crossing lane always finds its crossing topic.
// Only a live topic (k < K, k != K1) may be drawn by the sweep: lanes past
// K, and K1, add no mass and are never chosen. A draw past the last lane's
// end (u within rounding of 1) takes K-1, as the reference does.
//
// Two routes of the one body, chosen by K alone (kGlobal): the staged
// route above while a warp's two padded rows fit one block's shared memory
// (K <= 25,824), and past that the global route, in which the warp reads
// its D and W_hat rows straight from global memory (through L1 and L2)
// with the same lane blocks, the same loads, the same walk and the same
// order of additions. Only where a value is read from differs, so at any
// K the two give the same bits (the reference has no cap on K).
//
// Rounding: built without FMA contraction (--fmad=false) and written with
// explicit _rn intrinsics, so every product and sum rounds once, as in the
// plain PyTorch twin. Only the order of the sums differs (per-lane blocks
// and a warp tree here, PyTorch's reduction and cumsum there).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRun = 16;           // consecutive tokens a warp draws
constexpr int kMaxWarps = 8;       // warps a block
constexpr int kSmemBudget = 75 * 1024;  // staged rows a block: 3 blocks an SM
constexpr int kBlocksPerSm = 3;    // registers capped to match the rows' fit
constexpr int kMaxSmem = 232448;   // sm_90: shared bytes one block may take
constexpr int kPreLoads = 8;       // 16-byte loads a lane prefetches a row

struct Window {
  const int32_t* tile_first;  // (n_tiles,) first word of each tile's run
  int tile_size;              // tokens per tile
  int win;                    // window rows
  int n_words;                // V
};

struct Stats {                // per word
  const int32_t* k1;
  const float* a1;
  const float* q;
};

// Staged index of topic k: 4 words of padding after every 32; a row read
// from global memory is not padded.
template <bool kGlobal>
__device__ __forceinline__ int pad(int k) {
  return kGlobal ? k : k + (k >> 5) * 4;
}

// Floats one staged row takes.
int row_stride(int k) { return (k + 31) / 32 * 36; }

// Largest K whose two staged rows fit one block's shared memory (25,824).
int sample_fused_max_staged_topics() {
  return kMaxSmem / (2 * 36 * static_cast<int>(sizeof(float))) * 32;
}

// Copy a K-wide row of 4-byte values into shared memory, coalesced.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ row,
                                      T* __restrict__ dst, int k, bool vec,
                                      int lane) {
  if (vec) {
#pragma unroll 8
    for (int j = 4 * lane; j < k; j += 128)
      *reinterpret_cast<int4*>(dst + pad<false>(j)) =
          *reinterpret_cast<const int4*>(row + j);
  } else {
#pragma unroll 8
    for (int j = lane; j < k; j += 32) dst[pad<false>(j)] = row[j];
  }
}

// The token's draw from its rows, staged (padded) or in global memory:
// (topic, M, S'). Warp-wide.
template <bool kGlobal>
__device__ __forceinline__ int draw(const float* __restrict__ w_s,
                                    const int32_t* __restrict__ d_s,
                                    int k, int chunk, bool vec, int lane,
                                    int k1, float a1, float q_p, float u,
                                    float alpha, float* m_out,
                                    float* s_out) {
  const int lo = lane * chunk, hi = min(lo + chunk, k);
  auto mass = [&](int j, int32_t di, float w) {
    return j == k1 ? 0.f
                   : __fmul_rn(__fadd_rn(static_cast<float>(di), alpha), w);
  };
  // phase 0: this lane's share of sum d*w and its live mass, one pass
  float dot = 0.f, tot = 0.f;
  auto add = [&](int j, int32_t di, float w) {
    dot = __fadd_rn(dot, __fmul_rn(static_cast<float>(di), w));
    tot = __fadd_rn(tot, mass(j, di, w));
  };
  if (vec) {
#pragma unroll 4
    for (int j = lo; j < hi; j += 4) {
      const int pj = pad<kGlobal>(j);
      const float4 w4 = *reinterpret_cast<const float4*>(w_s + pj);
      const int4 d4 = *reinterpret_cast<const int4*>(d_s + pj);
      add(j, d4.x, w4.x);
      add(j + 1, d4.y, w4.y);
      add(j + 2, d4.z, w4.z);
      add(j + 3, d4.w, w4.w);
    }
  } else {
    for (int j = lo; j < hi; ++j)
      add(j, d_s[pad<kGlobal>(j)], w_s[pad<kGlobal>(j)]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)  // a+b == b+a: every lane agrees
    dot = __fadd_rn(dot, __shfl_xor_sync(kFull, dot, off));

  const float b1 = static_cast<float>(d_s[pad<kGlobal>(k1)]);
  const float m = __fmul_rn(a1, __fadd_rn(b1, alpha));
  const float s_p = __fsub_rn(dot, __fmul_rn(a1, b1));
  const float x = __fmul_rn(u, __fadd_rn(__fadd_rn(m, s_p), q_p));
  const float target = __fsub_rn(x, m);
  *m_out = m;
  *s_out = s_p;
  if (x < m) return k1;

  // phase 1: the lane whose block crosses x-M, then its block in order
  float incl = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = __fadd_rn(o, incl);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  const float end = __fadd_rn(excl, tot);
  const int n_live = max(hi - lo, 0) - (k1 >= lo && k1 < hi ? 1 : 0);
  const unsigned hit = __ballot_sync(kFull, n_live > 0 && end > target);
  if (!hit) return k - 1;                  // undershoot
  const int src = __ffs(hit) - 1;
  int found = -1, last = -1;
  if (lane == src) {
    float s = 0.f;
    for (int j = lo; j < hi; ++j) {
      const int pj = pad<kGlobal>(j);
      s = __fadd_rn(s, mass(j, d_s[pj], w_s[pj]));
      if (j != k1) {
        last = j;
        if (__fadd_rn(excl, s) > target) { found = j; break; }
      }
    }
  }
  // s ends at exactly `tot`, so src always finds its crossing; `last` (a
  // live topic) only guards the invariant
  return __shfl_sync(kFull, found >= 0 ? found : last, src);
}

template <bool kTiled>
__device__ __forceinline__ int row_of(const int32_t* __restrict__ word,
                                      const Window& window, int64_t t) {
  int v = word[t];
  if (kTiled) {  // the row through the tile's window (see the header)
    int base = window.tile_first[t / window.tile_size];
    base = min(max(base, 0), window.n_words - window.win);
    v = base + min(max(v - base, 0), window.win - 1);
  }
  return v;
}

// kPre: the next token's changing row is prefetched into registers
// (16-byte rows, K <= 32 * 4 * kPreLoads). kGlobal: the rows are read in
// place from global memory, nothing is staged (K past the staged fit).
template <bool kTiled, bool kPre, bool kGlobal>
__global__ void __launch_bounds__(kMaxWarps * 32, kBlocksPerSm)
sample_fused_kernel(const float* __restrict__ u,
                    const int32_t* __restrict__ doc,
                    const int32_t* __restrict__ word, const Window window,
                    const int32_t* __restrict__ D,
                    const float* __restrict__ W, const Stats stats,
                    int32_t* __restrict__ topic_out,
                    float* __restrict__ m_out, float* __restrict__ s_out,
                    float* __restrict__ q_out, int64_t n, int k, int chunk,
                    int stride, bool vec, float alpha) {
  static_assert(!(kPre && kGlobal), "the global route stages nothing");
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t0 = (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5)
                      + warp) * kRun;
  if (t0 >= n) return;  // the whole warp leaves together; no block barrier
  const int64_t t1 = min(t0 + kRun, n);
  float* w_s = reinterpret_cast<float*>(smem) + 2 * warp * stride;
  int32_t* d_s = reinterpret_cast<int32_t*>(w_s + stride);

  int cur_doc = doc[t0], cur_v = row_of<kTiled>(word, window, t0);
  if (!kGlobal) {
    stage(D + static_cast<int64_t>(cur_doc) * k, d_s, k, vec, lane);
    stage(W + static_cast<int64_t>(cur_v) * k, w_s, k, vec, lane);
  }
  int k1 = stats.k1[cur_v];
  float a1 = stats.a1[cur_v], q_p = stats.q[cur_v], ut = u[t0];
  __syncwarp();

  for (int64_t t = t0; t < t1; ++t) {
    // the next token's ids and stats, and its changing row in flight
    const bool more = t + 1 < t1;
    const int nd = more ? doc[t + 1] : cur_doc;
    const int nv = more ? row_of<kTiled>(word, window, t + 1) : cur_v;
    int nk1 = 0;
    float na1 = 0.f, nq = 0.f, nu = 0.f;
    if (more) {
      nk1 = stats.k1[nv];
      na1 = stats.a1[nv];
      nq = stats.q[nv];
      nu = u[t + 1];
    }
    const bool pre_d = kPre && nd != cur_doc;
    const bool pre_w = kPre && !pre_d && nv != cur_v;
    int4 buf[kPre ? kPreLoads : 1];
    if (kPre && (pre_d || pre_w)) {
      const int32_t* src = pre_d
          ? D + static_cast<int64_t>(nd) * k
          : reinterpret_cast<const int32_t*>(W + static_cast<int64_t>(nv) * k);
#pragma unroll
      for (int c = 0; c < kPreLoads; ++c) {
        const int j = 4 * lane + 128 * c;
        if (j < k) buf[c] = *reinterpret_cast<const int4*>(src + j);
      }
    }

    float m, s_p;
    const int topic = kGlobal
        ? draw<true>(W + static_cast<int64_t>(cur_v) * k,
                     D + static_cast<int64_t>(cur_doc) * k, k, chunk, vec,
                     lane, k1, a1, q_p, ut, alpha, &m, &s_p)
        : draw<false>(w_s, d_s, k, chunk, vec, lane, k1, a1, q_p, ut, alpha,
                      &m, &s_p);
    if (lane == 0) {
      topic_out[t] = topic;
      m_out[t] = m;
      s_out[t] = s_p;
      q_out[t] = q_p;
    }
    if (!more) break;
    if (kGlobal) {
      cur_doc = nd;
      cur_v = nv;
    } else if (nd != cur_doc || nv != cur_v) {   // warp-uniform
      __syncwarp();                       // this token's reads are done
      if (kPre && (pre_d || pre_w)) {
        int32_t* dst = pre_d ? d_s : reinterpret_cast<int32_t*>(w_s);
#pragma unroll
        for (int c = 0; c < kPreLoads; ++c) {
          const int j = 4 * lane + 128 * c;
          if (j < k) *reinterpret_cast<int4*>(dst + pad<false>(j)) = buf[c];
        }
        if (pre_d) cur_doc = nd; else cur_v = nv;
      }
      if (nd != cur_doc) {
        stage(D + static_cast<int64_t>(nd) * k, d_s, k, vec, lane);
        cur_doc = nd;
      }
      if (nv != cur_v) {
        stage(W + static_cast<int64_t>(nv) * k, w_s, k, vec, lane);
        cur_v = nv;
      }
      __syncwarp();
    }
    k1 = nk1;
    a1 = na1;
    q_p = nq;
    ut = nu;
  }
}

template <bool kTiled, bool kPre, bool kGlobal>
int launch_as(const float* u, const int32_t* doc, const int32_t* word,
              const Window window, const int32_t* D, const float* W,
              const Stats stats, int32_t* topic, float* m, float* s,
              float* q, long long n, int k, int chunk, bool vec, float alpha,
              void* stream) {
  const int stride = kGlobal ? 0 : row_stride(k);
  const size_t per_warp = static_cast<size_t>(stride) * 2 * sizeof(float);
  int warps = kGlobal ? kMaxWarps : static_cast<int>(kSmemBudget / per_warp);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = per_warp * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_fused_kernel<kTiled, kPre, kGlobal>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long per_block = static_cast<long long>(warps) * kRun;
  const long long blocks = (n + per_block - 1) / per_block;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  sample_fused_kernel<kTiled, kPre, kGlobal>
      <<<static_cast<unsigned>(blocks), warps * 32, smem,
         static_cast<cudaStream_t>(stream)>>>(u, doc, word, window, D, W,
                                              stats, topic, m, s, q, n, k,
                                              chunk, stride, vec, alpha);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTiled>
int launch(const float* u, const int32_t* doc, const int32_t* word,
           const Window window, const int32_t* D, const float* W,
           const Stats stats, int32_t* topic, float* m, float* s, float* q,
           long long n, int k, float alpha, void* stream) {
  if (n <= 0) return 0;
  if (k < 1) return cudaErrorInvalidValue;
  // 16-byte loads need K % 4 == 0 and aligned row bases
  const bool vec = k % 4 == 0
      && reinterpret_cast<uintptr_t>(D) % 16 == 0
      && reinterpret_cast<uintptr_t>(W) % 16 == 0;
  int chunk = (k + 31) / 32;
  if (vec) chunk = (chunk + 3) / 4 * 4;
  if (k > sample_fused_max_staged_topics())   // the rows stay in place
    return launch_as<kTiled, false, true>(u, doc, word, window, D, W, stats,
                                          topic, m, s, q, n, k, chunk, vec,
                                          alpha, stream);
  if (vec && k <= 128 * kPreLoads)
    return launch_as<kTiled, true, false>(u, doc, word, window, D, W, stats,
                                          topic, m, s, q, n, k, chunk, vec,
                                          alpha, stream);
  return launch_as<kTiled, false, false>(u, doc, word, window, D, W, stats,
                                         topic, m, s, q, n, k, chunk, vec,
                                         alpha, stream);
}

}  // namespace

extern "C" {

// k1_w (V,) int32, a1_w and q_w (V,) float32: the words' K1, a1 and Q'.
// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int sample_fused_launch(const float* u, const int32_t* doc, const int32_t* word,
                        const int32_t* D, const float* W, const int32_t* k1_w,
                        const float* a1_w, const float* q_w, int32_t* topic,
                        float* m, float* s, float* q, long long n, int k,
                        float alpha, void* stream) {
  return launch<false>(u, doc, word, Window{nullptr, 1, 1, 1}, D, W,
                       Stats{k1_w, a1_w, q_w}, topic, m, s, q, n, k, alpha,
                       stream);
}

// The tiled variant: tile_first (n / tile_size rounded up,) holds each
// tile's first word; win <= n_words.
int sample_fused_tiled_launch(const float* u, const int32_t* doc,
                              const int32_t* word, const int32_t* tile_first,
                              int tile_size, int win, int n_words,
                              const int32_t* D, const float* W,
                              const int32_t* k1_w, const float* a1_w,
                              const float* q_w, int32_t* topic, float* m,
                              float* s, float* q, long long n, int k,
                              float alpha, void* stream) {
  if (tile_size < 1 || win < 1 || win > n_words) return cudaErrorInvalidValue;
  return launch<true>(u, doc, word, Window{tile_first, tile_size, win, n_words},
                      D, W, Stats{k1_w, a1_w, q_w}, topic, m, s, q, n, k,
                      alpha, stream);
}

const char* sample_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
