// Count-matrix rebuild: a shared-memory histogram per token tile (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/histogram.py:
//   histogram_partials (def :67, pallas_call :85, _kernel :38), folded by
//   histogram (:101)
// which, per tile of T tokens, counts the tokens whose row lies in
// [base, base + R) into an (R x K) partial by a double one-hot matmul on
// the MXU (base = the tile's first row), marks them `covered`, and leaves
// the fold (a segment add of the partials) and the uncovered tokens (a
// scatter) to XLA. The reference's (n_tiles, R, K) partials would take
// ~100 GB at 100 M tokens, so here the fold happens inside the kernel:
//
//   one block per token tile; for each block of KB = 128 topics it
//   accumulates the tile's (R x KB) partial in shared memory with shared
//   atomics, then adds the nonzero entries into out[base + r] with global
//   atomics (two tiles may share a row at their boundary). Tokens outside
//   the tile's row window add their weight with a global atomic add;
//   weight-0 tokens add nothing. Rows are scanned only up to the last one
//   a covered token uses, so a tile of a long word or document costs few
//   shared entries.
//
// Integer adds commute, so the result is exact in any order: bitwise
// equal to index_put_(accumulate=True) and to torch.bincount. A token adds
// its weight where the reference's partials add 1 for every covered
// token; the two agree on 0/1 weights, the only ones the callers pass.
// Tokens whose row or topic lies outside the matrix add nothing.
//
// The partials variant keeps the reference's signature for parity tests:
// it writes every tile's full (R x K) partial and the covered mask, and
// leaves the fold to the caller.
//
// Bound: bytes. 12 bytes per token read (row, topic, weight) plus one
// write of the (n_rows, K) int32 output.

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

int histogram_max_rows() {
  return (kMaxSmem - 1024) / (kTopicBlock * static_cast<int>(sizeof(int32_t)));
}

const char* histogram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
