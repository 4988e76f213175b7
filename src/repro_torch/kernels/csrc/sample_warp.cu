// Warp MH engine kernels (sampler="warp") for sm_90a: the Vose alias-table
// build and the Metropolis-Hastings chain.
//
// Replaces the TPU kernel of src/repro/kernels/sample_warp.py:
//   sample_warp_tiled (def :107, pallas_call :164, _kernel :54)
// which, per token tile, (1) builds Vose alias tables for the tile's
// (win, K) window of the scan-start W~ in VMEM, (2) replays the word-
// proposal draws against them, and (3) runs the MH cycles. Here the work
// is split in two kernels:
//
//   vose_build  -> step 1, once per table build over all V rows.
//   warp_chain  -> steps 2 and 3, one thread per token.
//
// Why the split: alias tables are row-independent (the reference pins a
// window's tables equal to the slice of the global ones), so building
// every row once per build is bitwise what every tile would build. The
// TPU design rebuilds each tile's window per tile: at K = 1000 a 64-word
// window of prob, alias and q is 768 KB, against 227 KB of shared memory a
// block, and ~780,000 tiles an iteration would rebuild each row hundreds
// of times.
//
// vose_build: the pairing loop of core/mh.py run_vose on one row per warp.
// The warp loads the row's scaled weights (q*K) and its small and large
// queues (from mh.alias_queues, a sort left in PyTorch) into shared memory,
// coalesced; lane 0 runs the K sequential steps there; the warp writes prob
// and alias back, coalesced. Each step follows the reference exactly: the
// `has` gate, the clipped queue reads, prob[s] = scaled[s], alias[s] = l,
// lval = scaled[l] - (1 - scaled[s]), and the append of a demoted large to
// the small queue at s_tail. Once `has` is false it stays false, so the
// loop stops there. Bound: bytes, 5*V*K*4 (three (V, K) inputs read once,
// two written once); the design is latency-bound on the serial loop
// instead (one lane per row), which later work can overlap across rows.
//
// warp_chain: per token t with s = s0[t], v = word[t], d = doc[t], for
// each cycle c:
//   doc proposal  td = t_doc[c, t]:   accept if u_acc[c,0,t]*W[v,s] < W[v,td]
//   word proposal j = min(int(u_draw[c,0,t]*K), K-1);
//                 tw = u_draw[c,1,t] < prob[v,j] ? j : alias[v,j]
//     num = ((D[d,tw]+alpha)*W[v,tw])*q[v,s]
//     den = ((D[d,s]+alpha)*W[v,s])*q[v,tw]
//     accept if u_acc[c,1,t]*den < num.
// Outputs the final topic and the number of accepted proposals. Unlike the
// Pallas kernel, which takes (N, K) pre-gathered D rows (400 GB at 100 M
// tokens, K = 1000), the kernel gathers D[d,k], W[v,k], q[v,k], prob[v,j]
// and alias[v,j] itself by id, with 64-bit offsets.
// The tiled variant reads the word's rows through its tile's window as the
// Pallas kernel does (row = base + clip(word - base, 0, win - 1), base =
// clip(tile_first[t / tile_size], 0, V - win)); for every tile whose word
// run fits the window that is the word itself, so both launches read the
// same rows through the same code and are bitwise equal.
// Bound: bytes. About 10 random 4-byte reads per token per cycle, each a
// 32-byte sector, plus 4 + 8 + 8 bytes of streamed proposals and uniforms
// per cycle and 20 bytes of ids and outputs per token. One thread per
// token keeps the most reads in flight.
//
// Rounding: built without FMA contraction (--fmad=false) and written with
// _rn intrinsics in the reference's order, so every product and sum rounds
// once as in the plain PyTorch twin; no division anywhere.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

// Shared memory one block may take on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;
constexpr int kVoseArrays = 5;  // scaled, squeue, lqueue, prob, alias

__global__ void vose_build_kernel(const float* __restrict__ scaled,
                                  const int32_t* __restrict__ squeue,
                                  const int32_t* __restrict__ lqueue,
                                  const int32_t* __restrict__ n_small,
                                  float* __restrict__ prob,
                                  int32_t* __restrict__ alias, int64_t rows,
                                  int k) {
  extern __shared__ unsigned char smem_raw[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (r >= rows) return;  // the whole warp leaves together; no block barrier
  float* sc = reinterpret_cast<float*>(smem_raw) +
              static_cast<size_t>(warp) * kVoseArrays * k;
  int32_t* sq = reinterpret_cast<int32_t*>(sc + k);
  int32_t* lq = sq + k;
  float* pr = reinterpret_cast<float*>(lq + k);
  int32_t* al = reinterpret_cast<int32_t*>(pr + k);
  const int64_t off = r * k;
  for (int j = lane; j < k; j += 32) {
    sc[j] = scaled[off + j];
    sq[j] = squeue[off + j];
    lq[j] = lqueue[off + j];
    pr[j] = 1.0f;
    al[j] = j;
  }
  __syncwarp();
  if (lane == 0) {
    int s_head = 0, s_tail = n_small[r], l_head = 0;
    const int n_large = k - s_tail;
    for (int step = 0; step < k; ++step) {
      if (!(s_head < s_tail && l_head < n_large)) break;  // `has` stays false
      const int s = sq[min(max(s_head, 0), k - 1)];
      const int l = lq[min(max(l_head, 0), k - 1)];
      const float sval = sc[s];
      pr[s] = sval;
      al[s] = l;
      const float lval = __fsub_rn(sc[l], __fsub_rn(1.0f, sval));
      sc[l] = lval;
      ++s_head;
      if (lval < 1.0f) {  // demote the large slot to the small queue
        sq[min(max(s_tail, 0), k - 1)] = l;
        ++s_tail;
        ++l_head;
      }
    }
  }
  __syncwarp();
  for (int j = lane; j < k; j += 32) {
    prob[off + j] = pr[j];
    alias[off + j] = al[j];
  }
}

struct Window {
  const int32_t* tile_first;  // (n_tiles,) first word of each tile's run
  int tile_size;              // tokens per tile
  int win;                    // window rows
  int n_words;                // V
};

template <bool kTiled>
__global__ void warp_chain_kernel(
    const int32_t* __restrict__ s0, const int32_t* __restrict__ doc,
    const int32_t* __restrict__ word, const Window window,
    const int32_t* __restrict__ t_doc, const float* __restrict__ u_draw,
    const float* __restrict__ u_acc, const int32_t* __restrict__ D,
    const float* __restrict__ W, const float* __restrict__ q,
    const float* __restrict__ prob, const int32_t* __restrict__ alias,
    int32_t* __restrict__ s_out, int32_t* __restrict__ acc_out, int64_t n,
    int k, int n_cycles, float alpha) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n) return;
  int v = word[t];
  if (kTiled) {  // the row through the tile's window (see the header)
    int base = window.tile_first[t / window.tile_size];
    base = min(max(base, 0), window.n_words - window.win);
    v = base + min(max(v - base, 0), window.win - 1);
  }
  const int64_t wrow = static_cast<int64_t>(v) * k;
  const int64_t drow = static_cast<int64_t>(doc[t]) * k;
  const float kf = static_cast<float>(k);
  int s = s0[t];
  int n_acc = 0;
  for (int c = 0; c < n_cycles; ++c) {
    const int64_t u0 = static_cast<int64_t>(2 * c) * n + t;
    const int64_t u1 = u0 + n;
    // doc proposal: the (D + alpha) factors cancel against the target's
    const int td = t_doc[static_cast<int64_t>(c) * n + t];
    {
      const float num = W[wrow + td];
      const float den = W[wrow + s];
      const bool acc = __fmul_rn(u_acc[u0], den) < num;
      n_acc += acc;
      s = acc ? td : s;
    }
    // word proposal from the alias tables, accepted against the live
    // counts with the table distribution's correction
    int j = __float2int_rz(__fmul_rn(u_draw[u0], kf));
    j = min(j, k - 1);
    const int tw = u_draw[u1] < prob[wrow + j] ? j : alias[wrow + j];
    const float num = __fmul_rn(
        __fmul_rn(__fadd_rn(__int2float_rn(D[drow + tw]), alpha), W[wrow + tw]),
        q[wrow + s]);
    const float den = __fmul_rn(
        __fmul_rn(__fadd_rn(__int2float_rn(D[drow + s]), alpha), W[wrow + s]),
        q[wrow + tw]);
    const bool acc = __fmul_rn(u_acc[u1], den) < num;
    n_acc += acc;
    s = acc ? tw : s;
  }
  s_out[t] = s;
  acc_out[t] = n_acc;
}

template <bool kTiled>
int chain_launch(const int32_t* s0, const int32_t* doc, const int32_t* word,
                 const Window window, const int32_t* t_doc,
                 const float* u_draw, const float* u_acc, const int32_t* D,
                 const float* W, const float* q, const float* prob,
                 const int32_t* alias, int32_t* s_out, int32_t* acc_out,
                 long long n, int k, int n_cycles, float alpha, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || n_cycles < 0) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  warp_chain_kernel<kTiled><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      s0, doc, word, window, t_doc, u_draw, u_acc, D, W, q, prob, alias, s_out,
      acc_out, n, k, n_cycles, alpha);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Largest K whose row fits one warp's shared memory in vose_build.
int vose_build_max_topics() {
  return kMaxSmem / (kVoseArrays * static_cast<int>(sizeof(float)));
}

// prob, alias (rows, k) from scaled (rows, k) f32, squeue/lqueue (rows, k)
// int32 and n_small (rows,) int32; launch on `stream`, return the
// cudaError_t of the launch (0 = success).
int vose_build_launch(const float* scaled, const int32_t* squeue,
                      const int32_t* lqueue, const int32_t* n_small,
                      float* prob, int32_t* alias, long long rows, int k,
                      void* stream) {
  if (rows <= 0) return 0;
  if (k < 1 || k > vose_build_max_topics()) return cudaErrorInvalidValue;
  const size_t row_bytes = static_cast<size_t>(k) * kVoseArrays * 4;
  int warps = static_cast<int>((48 * 1024) / row_bytes);
  if (warps > 4) warps = 4;
  if (warps < 1) warps = 1;
  const size_t smem = row_bytes * warps;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vose_build_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  vose_build_kernel<<<static_cast<unsigned>(blocks), 32 * warps, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      scaled, squeue, lqueue, n_small, prob, alias, rows, k);
  return static_cast<int>(cudaGetLastError());
}

// The MH chain over n tokens: t_doc (n_cycles, n) int32, u_draw and u_acc
// (n_cycles, 2, n) f32; D (M, k) int32; W, q, prob (V, k) f32; alias (V, k)
// int32. Writes s_out and acc_out (n,) int32.
int warp_chain_launch(const int32_t* s0, const int32_t* doc,
                      const int32_t* word, const int32_t* t_doc,
                      const float* u_draw, const float* u_acc,
                      const int32_t* D, const float* W, const float* q,
                      const float* prob, const int32_t* alias, int32_t* s_out,
                      int32_t* acc_out, long long n, int k, int n_cycles,
                      float alpha, void* stream) {
  return chain_launch<false>(s0, doc, word, Window{nullptr, 1, 1, 1}, t_doc,
                             u_draw, u_acc, D, W, q, prob, alias, s_out,
                             acc_out, n, k, n_cycles, alpha, stream);
}

// The tiled variant: tile_first (n / tile_size rounded up,) holds each
// tile's first word; win <= n_words.
int warp_chain_tiled_launch(const int32_t* s0, const int32_t* doc,
                            const int32_t* word, const int32_t* tile_first,
                            int tile_size, int win, int n_words,
                            const int32_t* t_doc, const float* u_draw,
                            const float* u_acc, const int32_t* D,
                            const float* W, const float* q, const float* prob,
                            const int32_t* alias, int32_t* s_out,
                            int32_t* acc_out, long long n, int k, int n_cycles,
                            float alpha, void* stream) {
  if (tile_size < 1 || win < 1 || win > n_words) return cudaErrorInvalidValue;
  return chain_launch<true>(s0, doc, word,
                            Window{tile_first, tile_size, win, n_words}, t_doc,
                            u_draw, u_acc, D, W, q, prob, alias, s_out,
                            acc_out, n, k, n_cycles, alpha, stream);
}

const char* sample_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
