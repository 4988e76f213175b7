// O(live slots) three-branch topic draw over packed sparse D rows, one warp
// per token (sm_90a): the tail-word sampler of the hybrid state (paper
// §IV-C), with the Q' branch finished in the same warp.
//
// Replaces two TPU kernels of src/repro/kernels/sample_sparse.py, which
// share one body (_draw :44-72):
//   sample_sparse        (def :100, pallas_call :128) -> sample_sparse_launch
//   sample_sparse_tiled  (def :142, pallas_call :181) -> sample_sparse_tiled_launch
// and, on the main path's entries, the reference's Q' finish that follows
// them (src/repro/kernels/ops.py _q_fallback :73-93).
//
// Per token t with packed D row r = Dp[doc[t]] (L slots of idx<<16 | val,
// sorted by idx, so the empty slots, idx = 0xFFFF and val = 0, come last),
// word v = word[t] and per-word K1 = k1_w[v], a1 = a1_w[v], Q' = qp_w[v],
// and b1 = D[doc][K1]:
//
//   live slot j: val_j > 0, idx_j < K and idx_j != K1
//   p_j = val_j * W_hat[v][idx_j] on live slots, 0 elsewhere
//   M  = a1*(b1+alpha),  S' = sum_j p_j,  x = u*(M+S'+Q')
//   x < M                -> topic K1
//   else x < M+S' and the first live slot whose running sum of p exceeds
//        x-M exists      -> topic idx of that slot
//   else                 -> needs_q: with kFinish the first topic k whose
//        running sum of alpha*W'[k] (W_hat[v] with K1 counted as 0)
//        exceeds xq = (x-M)-S', clamped to K-1 (the reference's
//        searchsorted side="right" and clamp); without it topic -1, which
//        the caller finishes.
//
// Outputs (topic, needs_q, S'). The Pallas kernel takes W_hat gathered at
// the slot ids by XLA; this kernel gathers its own rows by doc and word
// id (a (C, L) gather of 27 M tail tokens would not fit on the card), and
// an empty slot adds no mass and its W_hat entry is never read: the
// reference's wrapper gathers W_hat at idx 0xFFFF in fill mode, which
// gives NaN there. `sample_sparse_launch` also takes a pre-gathered (N, L)
// W_hat for the reference's signature (`w_at`, with k = 0xFFFF); those
// entries return topic -1 on the Q' branch, as the Pallas kernel does.
//
// The tiled variant reads K1, a1 and Q' (and the W_hat row) through the
// tile's word window, as the Pallas kernel does: token t lies in tile
// t / tile_size, whose window starts at base = clip(tile_first[tile], 0,
// V - win), and its word is base + clip(word[t] - base, 0, win - 1). For a
// tile whose word run fits the window that is word[t] itself, so the two
// variants are bitwise equal. The window is read from global memory.
//
// Bound: bytes. Per token it reads the live prefix of its row (4 B a
// slot), the W_hat entries at its live slots, the W_hat row of a Q' token
// up to its crossing (4 B a topic), and 25 bytes of its own (u, doc, word,
// b1 read; topic, needs_q, S' written). Rows are L = min(longest
// document, K) slots wide, and most documents hold far fewer topics: on
// the NYTimes-shape corpus at K = 1000, L = 417 and a tail token's row
// has ~150 live slots.
// Design: nothing is staged, so no L or K cap. Pass 1 walks the row in
// 32-slot steps, lane j on slot step + j (coalesced), gathers W_hat at the
// live slots, sums S' per lane and stops after the first step whose ballot
// sees an empty slot; while it adds one step it already loads the next,
// once the step's ballot has found no empty slot, so no slot past the
// live prefix's step is read. S' is a warp sum. Pass 2 walks the same
// steps again (now in L1 or L2), recomputing each mass, as an inverse CDF
// with a warp scan and a carry, in slot order, and stops at the step that
// crosses x-M. The Q' finish walks the W_hat row in 32-topic steps the
// same way, the next step's entries in flight. Only live lanes may be
// drawn: the tree scan adds in another order on every lane, so a dead lane
// after the last live one can round above it (the fault found in
// sample_fused.cu).
//
// Rounding: built with --fmad=false and _rn intrinsics, so every product
// and sum rounds once, as in the plain twin; only the order of the sums
// differs (a warp tree here, PyTorch's reduction and cumsum there).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kEmptyIdx = 0xFFFFu;
constexpr uint32_t kEmptySlot = kEmptyIdx << 16;  // (EMPTY_IDX, 0)
constexpr int kWarps = 8;                         // warps a block

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

// Inclusive warp scan of c, then the carry of the steps before.
__device__ __forceinline__ float scan(float c, float carry, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(kFull, c, off);
    if (lane >= off) c = __fadd_rn(c, o);
  }
  return __fadd_rn(carry, c);
}

// The Q' draw: the first topic whose running sum of alpha*W'[k] exceeds
// xq, K-1 if none does. Warp-wide; w is the word's W_hat row.
__device__ __forceinline__ int q_draw(const float* __restrict__ w, int k,
                                      int k1, float xq, float alpha,
                                      int lane) {
  if (xq < 0.f) return 0;   // below every running sum, as searchsorted
  float carry = 0.f;
  float wn = lane < k ? w[lane] : 0.f;
  for (int base = 0; base < k; base += 32) {
    const float wk = wn;
    const int nj = base + 32 + lane;
    wn = nj < k ? w[nj] : 0.f;                // the next step in flight
    const int j = base + lane;
    const float q = (j < k && j != k1) ? __fmul_rn(alpha, wk) : 0.f;
    const float c = scan(q, carry, lane);
    const unsigned hit = __ballot_sync(kFull, q > 0.f && c > xq);
    if (hit) return base + __ffs(hit) - 1;
    carry = __shfl_sync(kFull, c, 31);
  }
  return k - 1;
}

template <bool kTiled, bool kFinish>
__global__ void __launch_bounds__(kWarps * 32)
sample_sparse_kernel(const float* __restrict__ u,
                     const int32_t* __restrict__ doc,
                     const int32_t* __restrict__ word, const Window window,
                     const Rows rows, const int32_t* __restrict__ k1_w,
                     const float* __restrict__ a1_w,
                     const float* __restrict__ qp_w,
                     const float* __restrict__ b1_t,
                     int32_t* __restrict__ topic_out,
                     bool* __restrict__ needs_q_out,
                     float* __restrict__ s_out, int64_t n, float alpha) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (t >= n) return;  // the whole warp leaves together; no block barrier

  const int L = rows.L;
  int v = word[t];
  if (kTiled) {  // the word through the tile's window (see the header)
    int base = window.tile_first[t / window.tile_size];
    base = min(max(base, 0), window.n_words - window.win);
    v = base + min(max(v - base, 0), window.win - 1);
  }
  const uint32_t* row = reinterpret_cast<const uint32_t*>(
      rows.packed + static_cast<int64_t>(doc[t]) * L);
  const bool by_slot = rows.w_at != nullptr;
  const float* w_row = by_slot ? rows.w_at + t * L
                               : rows.W + static_cast<int64_t>(v) * rows.k;
  const int k1 = k1_w[v];
  // the mass of slot j holding pk, -1 for a dead slot
  auto mass = [&](uint32_t pk, int j) {
    const int idx = static_cast<int>(pk >> 16);
    const int val = static_cast<int>(pk & 0xFFFFu);
    if (val > 0 && idx < rows.k && idx != k1)
      return __fmul_rn(static_cast<float>(val), w_row[by_slot ? j : idx]);
    return -1.f;
  };

  // pass 1: S' over the live prefix, 32 slots a step
  float sum_s = 0.f;
  int end = 0;                          // slots of the steps pass 1 read
  uint32_t pk = lane < L ? row[lane] : kEmptySlot;
  for (int base = 0;; base += 32) {
    const bool last = __ballot_sync(kFull, (pk >> 16) == kEmptyIdx) != 0;
    const int nj = base + 32 + lane;
    const uint32_t next = (!last && nj < L) ? row[nj] : kEmptySlot;
    const float p = mass(pk, base + lane);
    if (p >= 0.f) sum_s = __fadd_rn(sum_s, p);
    if (last) {
      end = min(base + 32, L);
      break;
    }
    pk = next;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum_s = __fadd_rn(sum_s, __shfl_xor_sync(kFull, sum_s, off));

  const float m = __fmul_rn(a1_w[v], __fadd_rn(b1_t[t], alpha));
  const float ms = __fadd_rn(m, sum_s);
  const float x = __fmul_rn(u[t], __fadd_rn(ms, qp_w[v]));
  const float target = __fsub_rn(x, m);
  int topic = k1;
  bool needs_q = false;
  if (!(x < m)) {
    int slot = -1;
    if (x < ms) {
      // pass 2: inverse CDF over the live slots, 32 slots a step
      float carry = 0.f;
      for (int base = 0; base < end; base += 32) {
        const int j = base + lane;
        const uint32_t pj = j < L ? row[j] : kEmptySlot;
        const float p = mass(pj, j);
        const bool live = p >= 0.f;
        const float c = scan(live ? p : 0.f, carry, lane);
        const unsigned hit = __ballot_sync(kFull, live && c > target);
        if (hit) {
          const int src = __ffs(hit) - 1;
          slot = base + src;
          topic = __shfl_sync(kFull, static_cast<int>(pj >> 16), src);
          break;
        }
        carry = __shfl_sync(kFull, c, 31);
      }
    }
    if (slot < 0) {
      needs_q = true;
      topic = kFinish ? q_draw(w_row, rows.k, k1, __fsub_rn(target, sum_s),
                               alpha, lane)
                      : -1;
    }
  }
  if (lane == 0) {
    topic_out[t] = topic;
    needs_q_out[t] = needs_q;
    s_out[t] = sum_s;
  }
}

template <bool kTiled, bool kFinish>
int launch_as(const float* u, const int32_t* doc, const int32_t* word,
              const Window window, const Rows rows, const int32_t* k1_w,
              const float* a1_w, const float* qp_w, const float* b1,
              int32_t* topic, bool* needs_q, float* s, long long n,
              float alpha, void* stream) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  sample_sparse_kernel<kTiled, kFinish>
      <<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
         static_cast<cudaStream_t>(stream)>>>(u, doc, word, window, rows,
                                              k1_w, a1_w, qp_w, b1, topic,
                                              needs_q, s, n, alpha);
  return static_cast<int>(cudaGetLastError());
}

// The main path's entries (W_hat by word) finish the Q' branch; the
// reference's (pre-gathered w_at) flag it.
template <bool kTiled>
int launch(const float* u, const int32_t* doc, const int32_t* word,
           const Window window, const Rows rows, const int32_t* k1_w,
           const float* a1_w, const float* qp_w, const float* b1,
           int32_t* topic, bool* needs_q, float* s, long long n, float alpha,
           void* stream) {
  if (n <= 0) return 0;
  if (rows.L < 1 || (rows.W == nullptr) == (rows.w_at == nullptr))
    return cudaErrorInvalidValue;
  if (rows.W != nullptr)
    return launch_as<kTiled, true>(u, doc, word, window, rows, k1_w, a1_w,
                                   qp_w, b1, topic, needs_q, s, n, alpha,
                                   stream);
  return launch_as<kTiled, false>(u, doc, word, window, rows, k1_w, a1_w,
                                  qp_w, b1, topic, needs_q, s, n, alpha,
                                  stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
// Exactly one of W (with k = K; the Q' branch finished) and w_at (with
// k = 0xFFFF; the Q' branch flagged with topic -1) is non-null.
int sample_sparse_launch(const float* u, const int32_t* doc,
                         const int32_t* word, const int32_t* packed, int L,
                         const float* W, int k, const float* w_at,
                         const int32_t* k1_w, const float* a1_w,
                         const float* qp_w, const float* b1, int32_t* topic,
                         bool* needs_q, float* s, long long n, float alpha,
                         void* stream) {
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
  if (tile_size < 1 || win < 1 || win > n_words) return cudaErrorInvalidValue;
  return launch<true>(u, doc, word, Window{tile_first, tile_size, win, n_words},
                      Rows{packed, L, W, k, w_at}, k1_w, a1_w, qp_w, b1,
                      topic, needs_q, s, n, alpha, stream);
}

const char* sample_sparse_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
