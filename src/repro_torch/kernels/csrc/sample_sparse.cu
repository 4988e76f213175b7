// O(L) three-branch topic draw over packed sparse D rows, one warp per
// token (sm_90a): the tail-word sampler of the hybrid state (paper §IV-C).
//
// Replaces two TPU kernels of src/repro/kernels/sample_sparse.py, which
// share one body (_draw :44-72):
//   sample_sparse        (def :100, pallas_call :128) -> sample_sparse_launch
//   sample_sparse_tiled  (def :142, pallas_call :181) -> sample_sparse_tiled_launch
//
// Per token t with packed D row r = Dp[doc[t]] (L slots of idx<<16 | val,
// sorted by idx, empty slots idx = 0xFFFF, val = 0), word v = word[t] and
// per-word K1 = k1_w[v], a1 = a1_w[v], Q' = qp_w[v], and b1 = D[doc][K1]:
//
//   live slot j: val_j > 0, idx_j < K and idx_j != K1
//   p_j = val_j * W_hat[v][idx_j] on live slots, 0 elsewhere
//   M  = a1*(b1+alpha),  S' = sum_j p_j,  x = u*(M+S'+Q')
//   x < M                -> topic K1
//   else x < M+S' and the first live slot whose running sum of p exceeds
//        x-M exists      -> topic idx of that slot
//   else                 -> topic -1, needs_q (the caller draws from Q')
//
// Outputs (topic, needs_q, S'). The Pallas kernel takes W_hat gathered at
// the slot ids by XLA; this kernel gathers its own rows by doc and word
// id (a (C, L) gather of 27 M tail tokens would not fit on the card), and
// an empty slot adds no mass and is never read: the reference's wrapper
// gathers W_hat at idx 0xFFFF in fill mode, which gives NaN there.
// `sample_sparse_launch` also takes a pre-gathered (N, L) W_hat for the
// reference's signature (`w_at`, with k = 0xFFFF).
//
// The tiled variant reads K1, a1 and Q' (and the W_hat row) through the
// tile's word window, as the Pallas kernel does: token t lies in tile
// t / tile_size, whose window starts at base = clip(tile_first[tile], 0,
// V - win), and its word is base + clip(word[t] - base, 0, win - 1). For a
// tile whose word run fits the window that is word[t] itself, so the two
// variants are bitwise equal. The window is read from global memory.
//
// Bound: bytes. Per token it reads L packed slots (4 B each), the W_hat
// entries at its live slots, and 33 bytes of its own (u, doc, word, b1;
// topic, needs_q, S'); about 3 flops per slot. Design: phase 0 reads the
// row's slots once, coalesced (lane j reads slots j, j+32, ...), gathers
// W_hat at the live ones, and stages the masses in shared memory (dead
// slots as -1); phase 1 walks the staged masses in 32-slot steps with a
// warp scan, in slot order, and stops at the first step that crosses the
// target. Only live lanes may be drawn: the tree scan adds in another
// order on every lane, so a dead lane after the last live one can round
// above it (the fault found in sample_fused.cu).
//
// Rounding: built with --fmad=false and _rn intrinsics, so every product
// and sum rounds once, as in the plain twin; only the order of the sums
// differs (a warp tree here, PyTorch's reduction there).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// Shared memory one block may take on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

struct Window {
  const int32_t* tile_first;  // (n_tiles,) first word of each tile's run
  int tile_size;              // tokens per tile
  int win;                    // window rows
  int n_words;                // V
};

struct Rows {
  const int32_t* packed;  // (M, L) packed sorted rows, read at doc[t]
  int L;
  const float* W;         // (V, K) W_hat read at (word, idx), or null
  int k;                  // K: slot ids at or past it are empty
  const float* w_at;      // (N, L) W_hat pre-gathered at the slots, or null
};

template <bool kTiled>
__global__ void sample_sparse_kernel(const float* __restrict__ u,
                                     const int32_t* __restrict__ doc,
                                     const int32_t* __restrict__ word,
                                     const Window window, const Rows rows,
                                     const int32_t* __restrict__ k1_w,
                                     const float* __restrict__ a1_w,
                                     const float* __restrict__ qp_w,
                                     const float* __restrict__ b1_t,
                                     int32_t* __restrict__ topic_out,
                                     bool* __restrict__ needs_q_out,
                                     float* __restrict__ s_out,
                                     int64_t n, float alpha) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= n) return;  // the whole warp leaves together; no block barrier below

  const int L = rows.L;
  float* p_s = smem + static_cast<size_t>(warp) * L;
  int v = word[t];
  if (kTiled) {  // the word through the tile's window (see the header)
    int base = window.tile_first[t / window.tile_size];
    base = min(max(base, 0), window.n_words - window.win);
    v = base + min(max(v - base, 0), window.win - 1);
  }
  const int32_t* row = rows.packed + static_cast<int64_t>(doc[t]) * L;
  const float* w_row = rows.w_at != nullptr ? rows.w_at + t * L
                                            : rows.W + static_cast<int64_t>(v) * rows.k;
  const bool by_slot = rows.w_at != nullptr;
  const int k1 = k1_w[v];

  // phase 0: live masses, staged; S' as a warp sum
  float sum_s = 0.f;
  for (int j = lane; j < L; j += 32) {
    const uint32_t pk = static_cast<uint32_t>(row[j]);
    const int idx = static_cast<int>(pk >> 16);
    const int val = static_cast<int>(pk & 0xFFFFu);
    float p = -1.f;  // dead
    if (val > 0 && idx < rows.k && idx != k1) {
      p = __fmul_rn(static_cast<float>(val), w_row[by_slot ? j : idx]);
      sum_s = __fadd_rn(sum_s, p);
    }
    p_s[j] = p;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum_s = __fadd_rn(sum_s, __shfl_xor_sync(kFull, sum_s, off));

  const float m = __fmul_rn(a1_w[v], __fadd_rn(b1_t[t], alpha));
  const float ms = __fadd_rn(m, sum_s);
  const float x = __fmul_rn(u[t], __fadd_rn(ms, qp_w[v]));
  int topic = k1;
  bool needs_q = false;
  if (!(x < m)) {
    int slot = -1;
    if (x < ms) {
      // phase 1: inverse CDF over the live slots, 32 slots per step
      __syncwarp();
      const float target = __fsub_rn(x, m);
      float carry = 0.f;
      for (int base = 0; base < L; base += 32) {
        const int j = base + lane;
        const float pj = j < L ? p_s[j] : -1.f;
        const bool live = pj >= 0.f;
        float c = live ? pj : 0.f;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float o = __shfl_up_sync(kFull, c, off);
          if (lane >= off) c = __fadd_rn(c, o);
        }
        c = __fadd_rn(carry, c);
        const unsigned hit = __ballot_sync(kFull, live && c > target);
        if (hit) { slot = base + __ffs(hit) - 1; break; }
        carry = __shfl_sync(kFull, c, 31);
      }
    }
    if (slot >= 0) {
      topic = static_cast<int>(static_cast<uint32_t>(row[slot]) >> 16);
    } else {
      topic = -1;
      needs_q = true;
    }
  }
  if (lane == 0) {
    topic_out[t] = topic;
    needs_q_out[t] = needs_q;
    s_out[t] = sum_s;
  }
}

template <bool kTiled>
int launch(const float* u, const int32_t* doc, const int32_t* word,
           const Window window, const Rows rows, const int32_t* k1_w,
           const float* a1_w, const float* qp_w, const float* b1,
           int32_t* topic, bool* needs_q, float* s, long long n, float alpha,
           void* stream) {
  if (n <= 0) return 0;
  if (rows.L < 1) return cudaErrorInvalidValue;
  const size_t row_bytes = static_cast<size_t>(rows.L) * sizeof(float);
  if (row_bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  int warps = static_cast<int>((48 * 1024) / row_bytes);
  if (warps > 4) warps = 4;
  if (warps < 1) warps = 1;
  const size_t smem = row_bytes * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_sparse_kernel<kTiled>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (n + warps - 1) / warps;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  sample_sparse_kernel<kTiled><<<static_cast<unsigned>(blocks), 32 * warps,
                                 smem, static_cast<cudaStream_t>(stream)>>>(
      u, doc, word, window, rows, k1_w, a1_w, qp_w, b1, topic, needs_q, s, n,
      alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Exactly one of W (with k = K) and w_at (with k = 0xFFFF) is non-null.
int sample_sparse_launch(const float* u, const int32_t* doc,
                         const int32_t* word, const int32_t* packed, int L,
                         const float* W, int k, const float* w_at,
                         const int32_t* k1_w, const float* a1_w,
                         const float* qp_w, const float* b1, int32_t* topic,
                         bool* needs_q, float* s, long long n, float alpha,
                         void* stream) {
  if ((W == nullptr) == (w_at == nullptr)) return cudaErrorInvalidValue;
  return launch<false>(u, doc, word, Window{nullptr, 1, 1, 1},
                       Rows{packed, L, W, k, w_at}, k1_w, a1_w, qp_w, b1,
                       topic, needs_q, s, n, alpha, stream);
}

// The tiled variant: tile_first (n / tile_size rounded up,) holds each
// tile's first word; win <= n_words.
int sample_sparse_tiled_launch(const float* u, const int32_t* doc,
                               const int32_t* word, const int32_t* tile_first,
                               int tile_size, int win, int n_words,
                               const int32_t* packed, int L, const float* W,
                               int k, const float* w_at, const int32_t* k1_w,
                               const float* a1_w, const float* qp_w,
                               const float* b1, int32_t* topic, bool* needs_q,
                               float* s, long long n, float alpha,
                               void* stream) {
  if ((W == nullptr) == (w_at == nullptr)) return cudaErrorInvalidValue;
  if (tile_size < 1 || win < 1 || win > n_words) return cudaErrorInvalidValue;
  return launch<true>(u, doc, word, Window{tile_first, tile_size, win, n_words},
                      Rows{packed, L, W, k, w_at}, k1_w, a1_w, qp_w, b1,
                      topic, needs_q, s, n, alpha, stream);
}

const char* sample_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sample_sparse_max_slots() { return kMaxSmem / sizeof(float); }

}  // extern "C"
