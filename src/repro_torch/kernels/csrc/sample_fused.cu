// Exact three-branch topic draw for LDA tokens, one warp per token (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/sample_fused.py, which
// share one body (_phase_body :68-140):
//   sample_fused        (def :202, pallas_call :234) -> sample_fused_launch
//   sample_fused_tiled  (def :251, pallas_call :304) -> sample_fused_tiled_launch
// Per token t with rows
// d = D[doc[t]] (int32, K) and w = W_hat[word[t]] (float32, K):
//
//   K1 = first index of max w,  a1 = w[K1],  b1 = d[K1]
//   M  = a1*(b1+alpha)
//   S' = sum_k d[k]*w[k] - a1*b1
//   Q' = alpha*(sum_k w[k] - a1)
//   x  = u*(M+S'+Q')
//   topic = K1 if x < M, else the first k != K1 whose running sum of
//           (d[k]+alpha)*w[k] exceeds x-M, else K-1 (float undershoot).
//
// Outputs (topic, M, S', Q'). Unlike the Pallas kernel, which takes rows
// gathered by XLA, this kernel gathers its own rows by doc and word id:
// at 100 M tokens x K = 1000 a pre-gathered (N, K) pair of matrices would
// not fit on the card.
//
// The tiled variant reads the W_hat row through its tile's word window,
// as the Pallas kernel does: token t lies in tile t / tile_size, whose
// window starts at base = clip(tile_first[tile], 0, V - win), and its row
// is base + clip(word[t] - base, 0, win - 1). For every token of a tile
// whose word run fits the window (the caller routes only such tiles
// here) that is word[t] itself, so the two variants read the same rows
// through the same code and are bitwise equal. The window is read from
// global memory (through L2): staging (win, K) rows in shared memory
// does not fit at K = 1000 beyond ~55 words and is a later design.
//
// Bound: bytes. Each token needs its D row and its W_hat row (K*8 bytes;
// at most N*K*8 bytes in all, less where tokens share rows) plus 28 bytes
// of its own (u, doc, word in; topic, M, S', Q' out). The arithmetic is
// about 7 flops per topic, far below the byte rate's 20 flops per byte.
// Design: phase 0 reads both rows once, coalesced (lane j reads topics
// j, j+32, ...), and stages them in shared memory; phase 1 walks the
// staged rows in 32-topic chunks with a warp scan, in topic order, and
// stops at the first chunk that crosses the target, so device memory is
// read once per row.
//
// Rounding: built without FMA contraction (--fmad=false) and written with
// explicit _rn intrinsics, so every product and sum rounds once, as in the
// plain PyTorch twin. Only the order of the sums differs (a warp tree
// here, PyTorch's reduction there).

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct Window {
  const int32_t* tile_first;  // (n_tiles,) first word of each tile's run
  int tile_size;              // tokens per tile
  int win;                    // window rows
  int n_words;                // V
};

template <bool kTiled>
__global__ void sample_fused_kernel(const float* __restrict__ u,
                                    const int32_t* __restrict__ doc,
                                    const int32_t* __restrict__ word,
                                    const Window window,
                                    const int32_t* __restrict__ D,
                                    const float* __restrict__ W,
                                    int32_t* __restrict__ topic_out,
                                    float* __restrict__ m_out,
                                    float* __restrict__ s_out,
                                    float* __restrict__ q_out,
                                    int64_t n, int k, float alpha) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (t >= n) return;  // the whole warp leaves together; no block barrier below

  float* w_s = smem + static_cast<size_t>(warp) * 2 * k;
  float* d_s = w_s + k;
  int v = word[t];
  if (kTiled) {  // the row through the tile's window (see the header)
    int base = window.tile_first[t / window.tile_size];
    base = min(max(base, 0), window.n_words - window.win);
    v = base + min(max(v - base, 0), window.win - 1);
  }
  const int32_t* d_row = D + static_cast<int64_t>(doc[t]) * k;
  const float* w_row = W + static_cast<int64_t>(v) * k;

  // phase 0: branch masses, running first-argmax
  float amax = __int_as_float(0xff800000), bmax = 0.f, sum_s = 0.f, sum_q = 0.f;
  int kmax = INT_MAX;
  for (int j = lane; j < k; j += 32) {
    const float w = w_row[j];
    const float d = static_cast<float>(d_row[j]);
    w_s[j] = w;
    d_s[j] = d;
    if (w > amax) { amax = w; kmax = j; bmax = d; }  // ascending j: first max
    sum_s = __fadd_rn(sum_s, __fmul_rn(d, w));
    sum_q = __fadd_rn(sum_q, w);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float oa = __shfl_xor_sync(kFull, amax, off);
    const int ok = __shfl_xor_sync(kFull, kmax, off);
    const float ob = __shfl_xor_sync(kFull, bmax, off);
    if (oa > amax || (oa == amax && ok < kmax)) { amax = oa; kmax = ok; bmax = ob; }
    sum_s = __fadd_rn(sum_s, __shfl_xor_sync(kFull, sum_s, off));
    sum_q = __fadd_rn(sum_q, __shfl_xor_sync(kFull, sum_q, off));
  }

  const float a1 = amax, b1 = bmax;
  const float m = __fmul_rn(a1, __fadd_rn(b1, alpha));
  const float s_p = __fsub_rn(sum_s, __fmul_rn(a1, b1));
  const float q_p = __fmul_rn(alpha, __fsub_rn(sum_q, a1));
  const float x = __fmul_rn(u[t], __fadd_rn(__fadd_rn(m, s_p), q_p));
  const float target = __fsub_rn(x, m);

  int topic = kmax;
  if (!(x < m)) {
    // phase 1: combined inverse CDF over k != K1, 32 topics per step
    __syncwarp();
    topic = k - 1;
    float carry = 0.f;
    for (int base = 0; base < k; base += 32) {
      const int j = base + lane;
      const bool live = j < k && j != kmax;
      float c = live ? __fmul_rn(__fadd_rn(d_s[j], alpha), w_s[j]) : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(kFull, c, off);
        if (lane >= off) c = __fadd_rn(c, o);
      }
      c = __fadd_rn(carry, c);
      // The tree scan adds in another order on every lane, so a lane past
      // K (or K1 itself) can round one ulp above the last live lane; only
      // live lanes may be drawn, else a draw with u near 1 lands past K.
      const unsigned hit = __ballot_sync(kFull, live && c > target);
      if (hit) { topic = base + __ffs(hit) - 1; break; }
      carry = __shfl_sync(kFull, c, 31);
    }
  }
  if (lane == 0) {
    topic_out[t] = topic;
    m_out[t] = m;
    s_out[t] = s_p;
    q_out[t] = q_p;
  }
}

// Shared memory one block may take on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;

template <bool kTiled>
int launch(const float* u, const int32_t* doc, const int32_t* word,
           const Window window, const int32_t* D, const float* W,
           int32_t* topic, float* m, float* s, float* q, long long n, int k,
           float alpha, void* stream) {
  if (n <= 0) return 0;
  const size_t row_bytes = static_cast<size_t>(k) * 2 * sizeof(float);
  if (row_bytes > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  int warps = static_cast<int>((48 * 1024) / row_bytes);
  if (warps > 4) warps = 4;
  if (warps < 1) warps = 1;
  const size_t smem = row_bytes * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sample_fused_kernel<kTiled>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (n + warps - 1) / warps;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  sample_fused_kernel<kTiled><<<static_cast<unsigned>(blocks), 32 * warps,
                                smem, static_cast<cudaStream_t>(stream)>>>(
      u, doc, word, window, D, W, topic, m, s, q, n, k, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
int sample_fused_launch(const float* u, const int32_t* doc, const int32_t* word,
                        const int32_t* D, const float* W, int32_t* topic,
                        float* m, float* s, float* q, long long n, int k,
                        float alpha, void* stream) {
  return launch<false>(u, doc, word, Window{nullptr, 1, 1, 1}, D, W, topic, m,
                       s, q, n, k, alpha, stream);
}

// The tiled variant: tile_first (n / tile_size rounded up,) holds each
// tile's first word; win <= n_words.
int sample_fused_tiled_launch(const float* u, const int32_t* doc,
                              const int32_t* word, const int32_t* tile_first,
                              int tile_size, int win, int n_words,
                              const int32_t* D, const float* W,
                              int32_t* topic, float* m, float* s, float* q,
                              long long n, int k, float alpha, void* stream) {
  if (tile_size < 1 || win < 1 || win > n_words) return cudaErrorInvalidValue;
  return launch<true>(u, doc, word, Window{tile_first, tile_size, win, n_words},
                      D, W, topic, m, s, q, n, k, alpha, stream);
}

const char* sample_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int sample_fused_max_topics() { return kMaxSmem / (2 * sizeof(float)); }

}  // extern "C"
