// Count-matrix rebuild: shared-memory histograms (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/histogram.py:
//   histogram_partials (def :67, pallas_call :85, _kernel :38), folded by
//   histogram (:101)
// which, per tile of T tokens, counts the tokens whose row lies in
// [base, base + R) into an (R x K) partial by a double one-hot matmul on
// the MXU (base = the tile's first row), marks them `covered`, and leaves
// the fold (a segment add of the partials) and the uncovered tokens (a
// scatter) to XLA. The reference's (n_tiles, R, K) partials would take
// ~100 GB at 100 M tokens, so here the fold happens inside the kernel.
//
// Two routes, one result: out[row, topic] += weight, integers, so exact in
// any order (bitwise equal to index_put_(accumulate=True) and to
// torch.bincount). Tokens whose row or topic lies outside the matrix add
// nothing.
//
// The sorted route (histogram_sorted_launch), the main path's: the rows
// are sorted and given as CSR offsets row_ptr (W: the word-sorted T; D:
// its doc-major order), so a token's row is implicit and it reads 8 bytes
// (topic, weight). A plan made once per corpus (kernels/histogram.py
// plan_row_blocks) gives each block a contiguous range of whole rows
// holding a few thousand tokens, at most max_rows of them. The block keeps
// those rows' full K-wide int32 counters in shared memory, makes one pass
// over its tokens (shared atomics; the lanes of a warp that hit one
// counter add once, found by __match_any_sync), and stores every row of
// its range once, coalesced 16-byte stores, zeros included: the output
// needs no clearing and owned rows no global atomic. A row longer than one
// block's budget is cut into pieces, each a block of its own that folds
// its counts into that row with global atomics after a first kernel has
// zeroed the row.
//
// The tile-window route (histogram_launch, histogram_partials_launch) takes
// rows in any order: one block per tile of tile_t tokens, an (R x 128)
// shared partial per block of 128 topics over the rows [base, base + R) of
// the tile's window, folded into the zeroed output with global atomics;
// tokens outside the window add with a global atomic. It serves unsorted
// streams and the reference's partials signature (every tile's (R x K)
// partial and its covered mask, the fold left to the caller).
//
// Bound: bytes. The sorted route reads 8 bytes a token plus the offsets
// and writes the (n_rows, K) int32 output once; the tile route reads 12
// bytes a token (row, topic, weight) and writes the output.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int kMaxSmem = 232448;  // sm_90, bytes one block may take
constexpr int kThreads = 256;
constexpr int kTopicBlock = 128;

template <bool kPartials>
__global__ void histogram_kernel(const int32_t* __restrict__ rows,
                                 const int32_t* __restrict__ topics,
                                 const int32_t* __restrict__ weights,
                                 const int32_t* __restrict__ tile_bases,
                                 int64_t n, int tile_t, int R, int k,
                                 int64_t n_rows, int32_t* __restrict__ out,
                                 int32_t* __restrict__ partials,
                                 uint8_t* __restrict__ covered) {
  extern __shared__ int32_t part[];  // (R, kTopicBlock)
  __shared__ int rows_used;
  const int64_t tile = blockIdx.x;
  const int64_t lo = tile * tile_t;
  const int64_t hi = min(lo + tile_t, n);
  const int base = tile_bases != nullptr ? tile_bases[tile] : rows[lo];
  if (threadIdx.x == 0) rows_used = kPartials ? R : 0;
  __syncthreads();
  for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const int64_t r = static_cast<int64_t>(rows[i]) - base;
    const int w = weights[i];
    const bool in_win = r >= 0 && r < R;
    if (kPartials) {
      covered[i] = in_win && w > 0;
    } else if (w > 0) {
      if (in_win) {
        atomicMax(&rows_used, static_cast<int>(r) + 1);
      } else {  // outside the tile's window: the fallback scatter
        const int row = rows[i], t = topics[i];
        if (row >= 0 && row < n_rows && t >= 0 && t < k)
          atomicAdd(&out[static_cast<int64_t>(row) * k + t], w);
      }
    }
  }
  __syncthreads();
  const int used = rows_used;
  for (int kb = 0; kb < k; kb += kTopicBlock) {
    const int kw = min(kTopicBlock, k - kb);
    for (int e = threadIdx.x; e < used * kTopicBlock; e += blockDim.x)
      part[e] = 0;
    __syncthreads();
    for (int64_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const int64_t r = static_cast<int64_t>(rows[i]) - base;
      const int w = weights[i];
      const int t = topics[i] - kb;
      if (r >= 0 && r < R && w > 0 && t >= 0 && t < kw)
        atomicAdd(&part[r * kTopicBlock + t], w);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < used * kw; e += blockDim.x) {
      const int r = e / kw, c = e - r * kw;
      const int val = part[r * kTopicBlock + c];
      if (kPartials) {
        partials[(tile * R + r) * k + kb + c] = val;
      } else if (val != 0) {
        const int64_t row = static_cast<int64_t>(base) + r;
        if (row >= 0 && row < n_rows) atomicAdd(&out[row * k + kb + c], val);
      }
    }
    __syncthreads();
  }
}

constexpr unsigned kFull = 0xffffffffu;

// Dynamic shared memory of a sorted-route block: the (max_rows + 1) row
// offsets, then max_rows * k counters, shifted by up to 3 so that counter
// i and out[g0 + i] share their 16-byte phase. The zeroing pass clears
// whole int4s from the unshifted base, up to shift + max_rows * k + 3
// ints, so 8 spare ints cover every shift.
size_t sorted_smem(int max_rows, int k) {
  const size_t ptrs = (static_cast<size_t>(max_rows) + 2) / 2 * 16;
  return ptrs + (static_cast<size_t>(max_rows) * k + 8) * sizeof(int32_t);
}

__global__ void zero_rows_kernel(const int64_t* __restrict__ rows, int k,
                                 int32_t* __restrict__ out) {
  int32_t* dst = out + rows[blockIdx.x] * k;
  for (int c = threadIdx.x; c < k; c += blockDim.x) dst[c] = 0;
}

__global__ void histogram_sorted_kernel(const int32_t* __restrict__ topics,
                                        const int32_t* __restrict__ weights,
                                        const int64_t* __restrict__ row_ptr,
                                        const int64_t* __restrict__ blocks,
                                        int max_rows, int k,
                                        int32_t* __restrict__ out) {
  extern __shared__ int4 smem[];
  const int64_t* b = blocks + 4 * static_cast<int64_t>(blockIdx.x);
  const int64_t row_lo = b[0], tok_lo = b[2], tok_hi = b[3];
  const int rows = static_cast<int>(b[1] - row_lo);
  const int64_t g0 = row_lo * k;                 // out[g0] is counter 0
  const int shift = static_cast<int>(g0 & 3);
  int64_t* ptr = reinterpret_cast<int64_t*>(smem);
  int32_t* base = reinterpret_cast<int32_t*>(ptr + (max_rows + 2) / 2 * 2);
  int32_t* cnt = base + shift;
  const int n_ent = rows * k;

  const int n4 = (shift + n_ent + 3) / 4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    reinterpret_cast<int4*>(base)[i] = make_int4(0, 0, 0, 0);
  for (int r = threadIdx.x; r <= rows; r += blockDim.x)
    ptr[r] = row_ptr[row_lo + r];
  __syncthreads();
  // a piece of a split row covers only part of its row's tokens
  const bool owned = ptr[0] == tok_lo && ptr[rows] == tok_hi;

  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  int r = 0;                      // this lane's row: its tokens ascend
  for (int64_t i0 = tok_lo + (threadIdx.x >> 5) * 32; i0 < tok_hi;
       i0 += warps * 32) {        // warp-uniform: every lane iterates
    const int64_t i = i0 + lane;
    const bool in = i < tok_hi;
    const int t = in ? topics[i] : 0;
    const int w = in ? weights[i] : 0;
    const bool valid = in && w != 0 && t >= 0 && t < k;
    if (in)
      while (i >= ptr[r + 1]) ++r;
    const int key = r * k + t;
    const unsigned active = __ballot_sync(kFull, valid);
    const bool unit = __all_sync(kFull, !valid || w == 1);
    if (valid) {
      if (unit) {                 // 0/1 weights: one add per distinct counter
        const unsigned peers = __match_any_sync(active, key);
        if (lane == __ffs(peers) - 1) atomicAdd(&cnt[key], __popc(peers));
      } else {
        atomicAdd(&cnt[key], w);
      }
    }
  }
  __syncthreads();

  if (owned) {                    // every row of the range, zeros included
    int32_t* dst = out + g0;
    const int head = min((4 - shift) & 3, n_ent);
    const int n_vec = (n_ent - head) / 4;
    for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = cnt[i];
    const int4* src4 = reinterpret_cast<const int4*>(cnt + head);
    int4* dst4 = reinterpret_cast<int4*>(dst + head);
    for (int i = threadIdx.x; i < n_vec; i += blockDim.x) dst4[i] = src4[i];
    for (int i = head + 4 * n_vec + threadIdx.x; i < n_ent; i += blockDim.x)
      dst[i] = cnt[i];
  } else {                        // a piece: fold into the zeroed row
    for (int c = threadIdx.x; c < n_ent; c += blockDim.x) {
      const int val = cnt[c];
      if (val != 0) atomicAdd(&out[g0 + c], val);
    }
  }
}

template <bool kPartials>
int launch(const int32_t* rows, const int32_t* topics, const int32_t* weights,
           const int32_t* tile_bases, long long n, int tile_t, int R, int k,
           long long n_rows, int32_t* out, int32_t* partials,
           uint8_t* covered, void* stream) {
  if (n <= 0) return 0;
  if (tile_t < 1 || R < 1 || k < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(R) * kTopicBlock * sizeof(int32_t);
  if (smem > static_cast<size_t>(kMaxSmem) - 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        histogram_kernel<kPartials>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (n + tile_t - 1) / tile_t;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  histogram_kernel<kPartials><<<static_cast<unsigned>(blocks), kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      rows, topics, weights, tile_bases, n, tile_t, R, k, n_rows, out,
      partials, covered);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (n_rows, k) int32, zeroed by the caller: out[rows[i], topics[i]] +=
// weights[i] over n tokens in tiles of tile_t with R-row windows. Launch on
// `stream`; returns the cudaError_t of the launch (0 = success).
int histogram_launch(const int32_t* rows, const int32_t* topics,
                     const int32_t* weights, long long n, int tile_t, int R,
                     int k, long long n_rows, int32_t* out, void* stream) {
  return launch<false>(rows, topics, weights, nullptr, n, tile_t, R, k, n_rows,
                       out, nullptr, nullptr, stream);
}

// The reference's partials: partials (n / tile_t, R, k) int32 and covered
// (n,) uint8, with each tile's window at tile_bases[tile]; n % tile_t == 0.
int histogram_partials_launch(const int32_t* rows, const int32_t* topics,
                              const int32_t* weights,
                              const int32_t* tile_bases, long long n,
                              int tile_t, int R, int k, int32_t* partials,
                              uint8_t* covered, void* stream) {
  if (tile_t < 1 || n % tile_t != 0) return cudaErrorInvalidValue;
  return launch<true>(rows, topics, weights, tile_bases, n, tile_t, R, k, 0,
                      nullptr, partials, covered, stream);
}

// The sorted route: out (n_rows, k) int32, 16-byte aligned, needs no
// clearing. blocks (n_blocks, 4) int64 holds each block's [row_lo, row_hi)
// and [tok_lo, tok_hi) (the plan), split_rows (n_split,) int64 the rows
// cut into pieces, row_ptr (n_rows + 1,) int64 the rows' offsets. Two
// launches on `stream` (zero the split rows, then count); returns the
// cudaError_t (0 = success).
int histogram_sorted_launch(const int32_t* topics, const int32_t* weights,
                            const int64_t* row_ptr, const int64_t* blocks,
                            long long n_blocks, const int64_t* split_rows,
                            long long n_split, int max_rows, int k,
                            int32_t* out, void* stream) {
  if (k < 1 || max_rows < 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return cudaErrorInvalidValue;
  if (n_blocks > INT_MAX || n_split > INT_MAX)
    return cudaErrorInvalidConfiguration;
  const size_t smem = sorted_smem(max_rows, k);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_split > 0) {
    zero_rows_kernel<<<static_cast<unsigned>(n_split), kThreads, 0, s>>>(
        split_rows, k, out);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (n_blocks <= 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        histogram_sorted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  histogram_sorted_kernel<<<static_cast<unsigned>(n_blocks), kThreads, smem,
                            s>>>(topics, weights, row_ptr, blocks, max_rows,
                                 k, out);
  return static_cast<int>(cudaGetLastError());
}

int histogram_max_rows() {
  return (kMaxSmem - 1024) / (kTopicBlock * static_cast<int>(sizeof(int32_t)));
}

const char* histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
