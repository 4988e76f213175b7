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
// ---------------------------------------------------------------------------
// vose_build: core/mh.py run_vose on the queues of mh.alias_queues.
//
// Two instantiations of one body (kBuild):
//   vose_tables_launch  (main path) builds each row's queues itself;
//   vose_build_launch   (the reference's signature) reads them.
// A warp owns R rows. Per row group it runs four phases:
//   1. The rows of scaled (= q*K) are copied into the prob arrays in
//      shared memory (cp.async, coalesced, every copy in flight at once).
//      Building, the warp counts the row's smalls (scaled < 1), then lays
//      out the queue's slots in 32-slot steps with __ballot_sync and __popc
//      prefix counts: the smalls ascending at [0, n_small), the larges
//      ascending after them. That is mh.alias_queues' squeue, and its
//      lqueue's larges are the same entries from n_small on: a stable
//      partition, integer work, so bitwise the sort. Reading, the slots
//      are squeue[0, n_small) and lqueue[0, n_large): the only queue
//      entries run_vose reads. alias = j is set for every slot.
//   2. Lane r runs row r's sequential pairing steps, R rows at once.
//   3. prob = 1 for every slot the loop never popped.
//   4. The warp writes prob and alias out, coalesced.
// The pairing loop must stay sequential (its order fixes the bits of prob
// and alias), so the design shortens each step to one dependency on its
// predecessor's residual, from four facts of run_vose:
//   - a slot's value changes once at most: the head large's residual lives
//     in a register and is stored when the large is demoted. So prob[j]
//     holds slot j's value throughout, and a pop writes no prob: run_vose
//     sets prob[s] to the value the slot has when popped, which is final;
//   - the queue's slots never change: the demotion appends at s_tail, and
//     s_tail = n_small + l_head always (both move only on demotion), which
//     is the head large's own entry. So the slot two positions on is
//     loaded two steps ahead and its value one step ahead. The one case
//     the look-ahead misses is the next position being that entry (s_head
//     + 1 == s_tail): then the next value is the residual in a register;
//   - the next large and its value are loaded one demotion ahead;
//   - prob[s] is final once popped, alias[s] is written once, at the pop.
// Under `has` (s_head < s_tail and l_head < n_large) every index stays in
// [0, K): s_tail = n_small + l_head <= K - 1 at each append, so run_vose's
// clip(s_tail, 0, K-1) never binds; when every large is demoted the last
// append lands on slot K - 1, after that entry was read as the head large,
// and s_tail reaches K. The slots never popped are those at queue
// positions [s_head, K): phase 3 sets their prob to 1; their alias stays j.
// prob and alias stay in shared memory and are written out coalesced,
// because a direct store from one lane is a partial 32 B sector write in
// L2 for every pop (101 M at V = 101,636, K = 1000).
// Shared memory per row: prob (f32), the queue slots and alias (u16, K <=
// 29,056 here): 8*K bytes. R = 32,000 / (8*K) rows a warp (1 to 32), one
// warp a block: at K = 1000, R = 4, and 7 blocks of 32 KB (and the 1 KB
// the runtime keeps a block) share an SM's 228 KB, so 28 rows are in
// flight per SM (PR 14's kernel held 8). The steps' latency, not the
// bytes, sets the time: at K = 1000 on the H100 (warp_variants.py, V =
// 101,636 rows), warps of 1, 2, 4 and 8 rows took 3.26, 2.54-2.59,
// 2.50-2.54 and 3.46-3.49 ms. One row a warp leaves a scheduler ~6
// one-lane warps to issue in turn; eight rows a warp leave it fewer than
// one warp to hide a step's latency with.
// Past K = 29,056 a row no longer fits a block (kGlobal): the warp works in
// global memory, one row at a time, on its prob and alias output rows in
// place and on a scratch row (the queue slots) that the wrapper allocates
// per launch; a fixed number of warps walk the rows in turn, so the
// scratch does not grow with V. Same steps, same bits.
// Bound: bytes, 3*V*K*4 (scaled read once, prob and alias written once);
// the design is latency-bound on the serial steps.
//
// ---------------------------------------------------------------------------
// warp_chain: per token, s = s0, v = word, d = doc; for each cycle c:
//   doc proposal  td:  accept if u_acc[c,0]*W[v,s] < W[v,td]
//   word proposal j = min(int(u_draw[c,0]*K), K-1);
//                 tw = u_draw[c,1] < prob[v,j] ? j : alias[v,j]
//     num = ((D[d,tw]+alpha)*W[v,tw])*q[v,s]
//     den = ((D[d,s]+alpha)*W[v,s])*q[v,tw]
//     accept if u_acc[c,1]*den < num.
// Two instantiations of one body (kTokens):
//   warp_chain_tokens(_tiled)_launch (main path): token i of the launch is
//     stream position t = idx[i]; s0 = topics[t], doc[t], word[t] and the
//     uniforms are read there, the doc proposal is drawn in the kernel
//     (mh.doc_proposals: L = length[d], slot = min(int(u0*L), max(L-1, 0)),
//     pos = clip(start[d] + slot, 0, n_perm-1), t_pos = topics[perm[pos]],
//     p_unif = ka/(L + ka) with ka = float32(K*alpha), t_unif =
//     min(int(u2*K), K-1); t_unif if u1 < p_unif or L == 0, else t_pos),
//     and the topic and the accepted count (u8, saturating at 255) are
//     written at t. `topics` holds the iteration-start topics; the kernel
//     never reads the array it writes.
//   warp_chain(_tiled)_launch (the rows contract): token i reads s0, doc,
//     word and t_doc[c] at i and writes at i.
// No proposal depends on s (s is s0 or a topic proposed earlier in the
// chain), so for a group of two cycles (all of them at the paths'
// mh_cycles = 2) the token first issues every read no accept decides: the
// doc proposals (u_doc, then perm and topics through the doc index), the
// word draws (prob[v,j], and alias[v,j] where the slot is not kept),
// W[v,x] at every proposed x and D[d,x], q[v,x] at the word proposals (and
// at s0, before the loop). The accept steps then run on those values in
// the same order of operations, so the bits do not change; D[d,td] and
// q[v,td] are read when a doc proposal is accepted. Reading those and
// every alias entry up front too, or reading each value when its cycle
// reaches it, was slower on the card (warp_variants.py, PERF.md): the
// chain is bound by its random reads more than by their latency.
// The tiled variant reads the word's rows through its tile's window as the
// Pallas kernel does (row = base + clip(word - base, 0, win - 1), base =
// clip(tile_first[i / tile_size], 0, V - win)); for every tile whose word
// run fits the window that is the word itself, so both launches read the
// same rows through the same code and are bitwise equal.
// Range checks: the rows contract's wrapper checks its ids on the host. On
// the main path the corpus's doc and word ids and the doc index are checked
// once per pipeline, and the kernel checks every value that comes from an
// array before it indexes with it (idx, doc, word, perm, topics): a bad one
// stops the launch (__trap: the next synchronisation reports a launch
// failure, as an out-of-range index does in PyTorch's own kernels), with
// no host synchronisation per launch.
// Bound: bytes. Per token, 4 B of idx, 8 of ids, 28 per cycle of
// uniforms and 5 written, plus the distinct 32 B sectors of D, W, q,
// prob, alias, length, start, perm and topics (at the token and where a
// doc proposal takes a token's topic) that the chain reads. One thread per
// token keeps the most reads in flight.
//
// Rounding: built without FMA contraction (--fmad=false) and written with
// _rn intrinsics in the reference's order, so every product, sum and the
// one division round once as in the plain PyTorch twin.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace {

// Shared memory one block may take on sm_90 (227 KB).
constexpr int kMaxSmem = 232448;
// vose_build's shared bytes a slot of a row: prob (f32), the queue slots
// and alias (u16).
constexpr int kVoseSlotBytes = 8;
// Shared bytes a one-warp block aims at: at K = 1000, four rows a warp.
constexpr int kVoseBlockBytes = 32000;
// Warps of the global route: its scratch is 4*k bytes a warp (0.25 GB at
// K = 29,057), and one serial lane a row keeps 16 warps an SM busy.
constexpr int kVoseGlobalWarps = 132 * 16;
constexpr int kVoseGlobalBlockWarps = 4;
// Cycles whose reads a chain issues before its accepts.
constexpr int kChainGroup = 2;

// Largest K whose row fits one block's shared memory (29,056); past it
// the global route runs.
int vose_max_topics() { return kMaxSmem / kVoseSlotBytes; }

int vose_rows_per_warp(int k) {
  const int r = kVoseBlockBytes / (kVoseSlotBytes * k);
  return r < 1 ? 1 : (r > 32 ? 32 : r);
}

// One row's working arrays: in shared memory (u16 slots) or, for the
// global route, the output rows and the warp's scratch row (int32 slots).
template <bool kGlobal>
struct VoseRow {
  using Slot = typename std::conditional<kGlobal, int32_t, uint16_t>::type;
  float* prob;  // each slot's value, then its prob
  Slot* alias;
  Slot* slot;   // the queue: smalls, then larges
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Phase 2: run_vose's pairing loop on one row whose queue holds the smalls
// at [0, ns) and the larges at [ns, k) and whose prob holds each slot's
// value; see the header for why each step depends only on the previous
// residual. Returns the first queue position never popped.
template <class Row>
__device__ __forceinline__ int vose_pair(const Row w, const int ns,
                                         const int k) {
  const int n_large = k - ns;
  if (!(ns > 0 && n_large > 0)) return 0;  // `has` is false from the start
  const int last = k - 1;
  int s_head = 0, s_tail = ns, l_head = 0;
  int s = w.slot[0];
  float sv = w.prob[s];
  int s1 = w.slot[min(1, last)];  // the slot at s_head + 1
  int l = w.slot[min(ns, last)];
  float lv = w.prob[l];
  int l2 = w.slot[min(ns + 1, last)];
  float lv2 = w.prob[l2];
  for (;;) {
    const int s2 = w.slot[min(s_head + 2, last)];
    float sv1 = w.prob[s1];
    w.alias[s] = static_cast<typename Row::Slot>(l);
    lv = __fsub_rn(lv, __fsub_rn(1.0f, sv));
    ++s_head;
    if (lv < 1.0f) {  // demote: (l, lv) joins the small queue at s_tail
      w.prob[l] = lv;
      if (s_head == s_tail) sv1 = lv;  // s1 is l: its value just changed
      ++s_tail;
      ++l_head;
      l = l2;
      lv = lv2;
      l2 = w.slot[min(ns + l_head + 1, last)];
      lv2 = w.prob[l2];
    }
    if (!(s_head < s_tail && l_head < n_large)) break;  // `has` stays false
    s = s1;
    sv = sv1;
    s1 = s2;
  }
  return s_head;
}

template <bool kGlobal, bool kBuild>
__global__ void vose_build_kernel(const float* __restrict__ scaled,
                                  const int32_t* __restrict__ squeue,
                                  const int32_t* __restrict__ lqueue,
                                  const int32_t* __restrict__ n_small,
                                  float* __restrict__ prob,
                                  int32_t* __restrict__ alias, int64_t rows,
                                  int k, int rows_per_warp,
                                  int32_t* __restrict__ slab) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using Row = VoseRow<kGlobal>;
  using Slot = typename Row::Slot;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t wid =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const int64_t n_warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  const int R = kGlobal ? 1 : rows_per_warp;
  const size_t row_bytes = static_cast<size_t>(k) * kVoseSlotBytes;
  unsigned char* mine = smem_raw + static_cast<size_t>(warp) * R * row_bytes;
  auto row_at = [&](int r, int64_t off) {
    Row w;
    if (kGlobal) {
      w.prob = prob + off;
      w.alias = reinterpret_cast<Slot*>(alias + off);
      w.slot = reinterpret_cast<Slot*>(slab + wid * k);
    } else {
      unsigned char* base = mine + static_cast<size_t>(r) * row_bytes;
      w.prob = reinterpret_cast<float*>(base);
      w.slot = reinterpret_cast<Slot*>(w.prob + k);
      w.alias = w.slot + k;
    }
    return w;
  };
  const int64_t n_groups = (rows + R - 1) / R;
  // the whole warp walks its row groups together; no block barrier below
  for (int64_t g = wid; g < n_groups; g += n_warps) {
    const int64_t row0 = g * R;
    const int nr = rows - row0 < R ? static_cast<int>(rows - row0) : R;
    // phase 1: the values, every copy of the group's rows in flight
    for (int r = 0; r < nr; ++r) {
      const int64_t off = (row0 + r) * k;
      float* dst = row_at(r, off).prob;
      for (int j = lane; j < k; j += 32) {
        if (kGlobal)
          dst[j] = scaled[off + j];
        else
          cp_async4(dst + j, scaled + off + j);
      }
    }
    if (!kGlobal) cp_async_wait_all();
    __syncwarp();
    int my_ns = 0;  // lane r: row r's small count
    for (int r = 0; r < nr; ++r) {
      const int64_t off = (row0 + r) * k;
      const Row w = row_at(r, off);
      int ns;
      if (kBuild) {
        int cnt = 0;
        for (int j = lane; j < k; j += 32) cnt += w.prob[j] < 1.0f;
        ns = __reduce_add_sync(0xffffffffu, cnt);
        int before = 0;  // smalls in the earlier 32-slot steps
        for (int base = 0; base < k; base += 32) {
          const int j = base + lane;
          const bool small = j < k && w.prob[j] < 1.0f;
          const unsigned m = __ballot_sync(0xffffffffu, small);
          const int s_rank = before + __popc(m & ((1u << lane) - 1u));
          if (j < k) w.slot[small ? s_rank : ns + (j - s_rank)] =
              static_cast<Slot>(j);
          before += __popc(m);
        }
      } else {
        // run_vose reads squeue[0, n_small) and lqueue[0, n_large) only;
        // an n_small outside [0, k) leaves `has` false either way
        ns = min(max(n_small[row0 + r], 0), k);
        for (int p = lane; p < k; p += 32)
          w.slot[p] = static_cast<Slot>(p < ns ? squeue[off + p]
                                               : lqueue[off + p - ns]);
      }
      for (int j = lane; j < k; j += 32) w.alias[j] = static_cast<Slot>(j);
      if (lane == r) my_ns = ns;
    }
    __syncwarp();
    int popped = 0;  // lane r: row r's first queue position never popped
    if (lane < nr)
      popped = vose_pair(row_at(lane, (row0 + lane) * k), my_ns, k);
    __syncwarp();
    for (int r = 0; r < nr; ++r) {  // phase 3
      const Row w = row_at(r, (row0 + r) * k);
      const int first = __shfl_sync(0xffffffffu, popped, r);
      for (int p = first + lane; p < k; p += 32) w.prob[w.slot[p]] = 1.0f;
    }
    __syncwarp();
    if (!kGlobal) {  // phase 4
      for (int r = 0; r < nr; ++r) {
        const Row w = row_at(r, 0);
        const int64_t off = (row0 + r) * k;
        for (int j = lane; j < k; j += 32) {
          prob[off + j] = w.prob[j];
          alias[off + j] = static_cast<int32_t>(w.alias[j]);
        }
      }
      __syncwarp();
    }
  }
}

template <bool kBuild>
int vose_launch(const float* scaled, const int32_t* squeue,
                const int32_t* lqueue, const int32_t* n_small, float* prob,
                int32_t* alias, long long rows, int k, int32_t* slab,
                void* stream) {
  if (rows <= 0) return 0;
  if (k < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > vose_max_topics()) {
    if (slab == nullptr) return cudaErrorInvalidValue;
    const long long warps = rows < kVoseGlobalWarps ? rows : kVoseGlobalWarps;
    const auto blocks = static_cast<unsigned>(
        (warps + kVoseGlobalBlockWarps - 1) / kVoseGlobalBlockWarps);
    vose_build_kernel<true, kBuild><<<blocks, 32 * kVoseGlobalBlockWarps, 0,
                                      s>>>(scaled, squeue, lqueue, n_small,
                                           prob, alias, rows, k, 1, slab);
    return static_cast<int>(cudaGetLastError());
  }
  const int r = vose_rows_per_warp(k);
  const size_t smem = static_cast<size_t>(r) * k * kVoseSlotBytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vose_build_kernel<false, kBuild>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (rows + r - 1) / r;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  vose_build_kernel<false, kBuild><<<static_cast<unsigned>(blocks), 32, smem,
                                     s>>>(scaled, squeue, lqueue, n_small,
                                          prob, alias, rows, k, r, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------

struct Window {
  const int32_t* tile_first;  // (n_tiles,) first word of each tile's run
  int tile_size;              // tokens per tile
  int win;                    // window rows
  int n_words;                // V
};

// The doc proposal's inputs (main-path entries).
struct DocDraw {
  const float* u_doc;     // (C, 3, N)
  const int32_t* start;   // (M,) first slot of each doc in perm
  const int32_t* length;  // (M,) real tokens of each doc
  const int32_t* perm;    // (n_perm,) token positions sorted by doc
  int n_perm;
  int n_docs;
  int n_words;
  float ka;               // float32(K * alpha)
};

struct Chain {
  const int32_t* idx;     // main path: (n,) stream positions
  const int32_t* topics;  // s0: (N,) iteration-start topics, or (n,)
  const int32_t* doc;
  const int32_t* word;
  const int32_t* t_doc;   // rows contract: (C, n) doc proposals
  const float* u_draw;    // (C, 2, N)
  const float* u_acc;     // (C, 2, N)
  const int32_t* D;
  const float* W;
  const float* q;
  const float* prob;
  const int32_t* alias;
  int32_t* s_out;
  void* acc_out;          // u8 (main path) or int32 (rows contract)
  int64_t n;              // tokens of the launch
  int64_t stride;         // N, the streams' length (n for the rows)
  int k;
  int n_cycles;
  float alpha;
};

__device__ __forceinline__ void require(bool ok) {
  if (!ok) __trap();
}

template <bool kTiled, bool kTokens>
__global__ void __launch_bounds__(256)
    warp_chain_kernel(const Chain a, const Window window, const DocDraw dd) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= a.n) return;
  const int64_t N = a.stride;
  const int64_t t = kTokens ? static_cast<int64_t>(a.idx[i]) : i;
  if (kTokens) require(t >= 0 && t < N);
  int v = a.word[t];
  const int d = a.doc[t];
  const int s0 = a.topics[t];
  if (kTokens)
    require(v >= 0 && v < dd.n_words && d >= 0 && d < dd.n_docs &&
            s0 >= 0 && s0 < a.k);
  if (kTiled) {  // the row through the tile's window (see the header)
    int base = window.tile_first[i / window.tile_size];
    base = min(max(base, 0), window.n_words - window.win);
    v = base + min(max(v - base, 0), window.win - 1);
  }
  const int k = a.k;
  const int64_t wrow = static_cast<int64_t>(v) * k;
  const int64_t drow = static_cast<int64_t>(d) * k;
  const float kf = static_cast<float>(k);
  int L = 0, st = 0;
  float lf = 0.0f, p_unif = 0.0f;
  if (kTokens) {
    L = dd.length[d];
    st = dd.start[d];
    lf = __int2float_rn(L);
    p_unif = __fdiv_rn(dd.ka, __fadd_rn(lf, dd.ka));
  }
  int s = s0;
  float ws = a.W[wrow + s];
  float ds = __int2float_rn(a.D[drow + s]);
  float qs = a.q[wrow + s];
  int n_acc = 0;
  for (int c0 = 0; c0 < a.n_cycles; c0 += kChainGroup) {
    int td[kChainGroup], tw[kChainGroup];
    float wtd[kChainGroup], wtw[kChainGroup], dtw[kChainGroup];
    float qtw[kChainGroup], ua0[kChainGroup], ua1[kChainGroup];
    // every read of the group that no accept decides
#pragma unroll
    for (int g = 0; g < kChainGroup; ++g) {
      const int c = c0 + g;
      if (c >= a.n_cycles) break;
      if (kTokens) {
        const float* u = dd.u_doc + 3 * c * N + t;
        const float u0 = u[0], u1 = u[N], u2 = u[2 * N];
        const int slot = min(__float2int_rz(__fmul_rn(u0, lf)), max(L - 1, 0));
        const int pos = min(max(st + slot, 0), dd.n_perm - 1);
        const int src = dd.perm[pos];
        require(src >= 0 && src < N);
        const int t_pos = a.topics[src];
        require(t_pos >= 0 && t_pos < k);
        const int t_unif = min(__float2int_rz(__fmul_rn(u2, kf)), k - 1);
        td[g] = (u1 < p_unif || L == 0) ? t_unif : t_pos;
      } else {
        td[g] = a.t_doc[c * N + t];
      }
      const float* ud = a.u_draw + 2 * c * N + t;
      const int j = min(__float2int_rz(__fmul_rn(ud[0], kf)), k - 1);
      tw[g] = ud[N] < a.prob[wrow + j] ? j : a.alias[wrow + j];
      wtd[g] = a.W[wrow + td[g]];
      wtw[g] = a.W[wrow + tw[g]];
      dtw[g] = __int2float_rn(a.D[drow + tw[g]]);
      qtw[g] = a.q[wrow + tw[g]];
      const float* ua = a.u_acc + 2 * c * N + t;
      ua0[g] = ua[0];
      ua1[g] = ua[N];
    }
    // the accept steps
#pragma unroll
    for (int g = 0; g < kChainGroup; ++g) {
      if (c0 + g >= a.n_cycles) break;
      // doc proposal: the (D + alpha) factors cancel against the target's
      bool acc = __fmul_rn(ua0[g], ws) < wtd[g];
      n_acc += acc;
      if (acc) {
        s = td[g];
        ws = wtd[g];
        ds = __int2float_rn(a.D[drow + s]);
        qs = a.q[wrow + s];
      }
      // word proposal from the alias tables, accepted against the live
      // counts with the table distribution's correction
      const float num = __fmul_rn(
          __fmul_rn(__fadd_rn(dtw[g], a.alpha), wtw[g]), qs);
      const float den = __fmul_rn(
          __fmul_rn(__fadd_rn(ds, a.alpha), ws), qtw[g]);
      acc = __fmul_rn(ua1[g], den) < num;
      n_acc += acc;
      if (acc) {
        s = tw[g];
        ws = wtw[g];
        ds = dtw[g];
        qs = qtw[g];
      }
    }
  }
  a.s_out[t] = s;
  if (kTokens)
    static_cast<uint8_t*>(a.acc_out)[t] =
        static_cast<uint8_t>(min(n_acc, 255));
  else
    static_cast<int32_t*>(a.acc_out)[t] = n_acc;
}

template <bool kTiled, bool kTokens>
int chain_launch(const Chain& a, const Window& window, const DocDraw& dd,
                 void* stream) {
  if (a.n <= 0) return 0;
  if (a.k < 1 || a.n_cycles < 0) return cudaErrorInvalidValue;
  if (kTiled && (window.tile_size < 1 || window.win < 1 ||
                 window.win > window.n_words))
    return cudaErrorInvalidValue;
  if (kTokens && dd.n_perm < 1) return cudaErrorInvalidValue;
  constexpr int kThreads = 256;
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  warp_chain_kernel<kTiled, kTokens><<<static_cast<unsigned>(blocks),
                                       kThreads, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
      a, window, dd);
  return static_cast<int>(cudaGetLastError());
}

Chain rows_chain(const int32_t* s0, const int32_t* doc, const int32_t* word,
                 const int32_t* t_doc, const float* u_draw,
                 const float* u_acc, const int32_t* D, const float* W,
                 const float* q, const float* prob, const int32_t* alias,
                 int32_t* s_out, int32_t* acc_out, long long n, int k,
                 int n_cycles, float alpha) {
  return Chain{nullptr, s0,   doc,   word,  t_doc,   u_draw, u_acc,
               D,       W,    q,     prob,  alias,   s_out,  acc_out,
               n,       n,    k,     n_cycles, alpha};
}

Chain tokens_chain(const int32_t* idx, const int32_t* topics,
                   const int32_t* doc, const int32_t* word,
                   const float* u_word, const float* u_acc, const int32_t* D,
                   const float* W, const float* q, const float* prob,
                   const int32_t* alias, int32_t* s_out, uint8_t* acc_out,
                   long long n, long long n_all, int k, int n_cycles,
                   float alpha) {
  return Chain{idx, topics, doc,   word,  nullptr, u_word, u_acc,
               D,   W,      q,     prob,  alias,   s_out,  acc_out,
               n,   n_all,  k,     n_cycles, alpha};
}

}  // namespace

extern "C" {

// Warps (and scratch rows of k int32 each) the global route runs for
// `rows` rows of k topics; 0 where the rows fit shared memory.
long long vose_build_slab_warps(long long rows, int k) {
  if (k <= vose_max_topics() || rows <= 0) return 0;
  return rows < kVoseGlobalWarps ? rows : kVoseGlobalWarps;
}

// prob, alias (rows, k) from scaled (rows, k) f32, the queues built in the
// kernel; slab (vose_build_slab_warps(rows, k), k) int32 scratch, or null
// where that is 0. Launch on `stream`, return the cudaError_t of the
// launch (0 = success).
int vose_tables_launch(const float* scaled, float* prob, int32_t* alias,
                       long long rows, int k, int32_t* slab, void* stream) {
  return vose_launch<true>(scaled, nullptr, nullptr, nullptr, prob, alias,
                           rows, k, slab, stream);
}

// The same from given queues: squeue/lqueue (rows, k) int32 and n_small
// (rows,) int32 as mh.alias_queues gives them.
int vose_build_launch(const float* scaled, const int32_t* squeue,
                      const int32_t* lqueue, const int32_t* n_small,
                      float* prob, int32_t* alias, long long rows, int k,
                      int32_t* slab, void* stream) {
  return vose_launch<false>(scaled, squeue, lqueue, n_small, prob, alias,
                            rows, k, slab, stream);
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
  return chain_launch<false, false>(
      rows_chain(s0, doc, word, t_doc, u_draw, u_acc, D, W, q, prob, alias,
                 s_out, acc_out, n, k, n_cycles, alpha),
      Window{nullptr, 1, 1, 1}, DocDraw{}, stream);
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
  return chain_launch<true, false>(
      rows_chain(s0, doc, word, t_doc, u_draw, u_acc, D, W, q, prob, alias,
                 s_out, acc_out, n, k, n_cycles, alpha),
      Window{tile_first, tile_size, win, n_words}, DocDraw{}, stream);
}

// The main path's chain over the n tokens at idx (n,) int32 of streams of
// n_all tokens: topics, doc, word (n_all,) int32 (topics at the iteration
// start); u_doc (n_cycles, 3, n_all), u_word and u_acc (n_cycles, 2, n_all)
// f32; the doc index start, length (n_docs,) and perm (n_perm,) int32;
// D (n_docs, k) int32; W, q, prob (n_words, k) f32; alias (n_words, k)
// int32; ka = float32(k * alpha). Writes s_out[idx] (int32) and
// acc_out[idx] (u8) of (n_all,) outputs.
int warp_chain_tokens_launch(
    const int32_t* idx, const int32_t* topics, const int32_t* doc,
    const int32_t* word, const float* u_doc, const int32_t* start,
    const int32_t* length, const int32_t* perm, int n_perm, int n_docs,
    int n_words, const float* u_word, const float* u_acc, const int32_t* D,
    const float* W, const float* q, const float* prob, const int32_t* alias,
    int32_t* s_out, uint8_t* acc_out, long long n, long long n_all, int k,
    int n_cycles, float alpha, float ka, void* stream) {
  return chain_launch<false, true>(
      tokens_chain(idx, topics, doc, word, u_word, u_acc, D, W, q, prob,
                   alias, s_out, acc_out, n, n_all, k, n_cycles, alpha),
      Window{nullptr, 1, 1, 1},
      DocDraw{u_doc, start, length, perm, n_perm, n_docs, n_words, ka},
      stream);
}

// The tiled variant: token i of the launch lies in tile i / tile_size,
// whose first word is tile_first[tile]; win <= n_words.
int warp_chain_tokens_tiled_launch(
    const int32_t* idx, const int32_t* tile_first, int tile_size, int win,
    const int32_t* topics, const int32_t* doc, const int32_t* word,
    const float* u_doc, const int32_t* start, const int32_t* length,
    const int32_t* perm, int n_perm, int n_docs, int n_words,
    const float* u_word, const float* u_acc, const int32_t* D, const float* W,
    const float* q, const float* prob, const int32_t* alias, int32_t* s_out,
    uint8_t* acc_out, long long n, long long n_all, int k, int n_cycles,
    float alpha, float ka, void* stream) {
  return chain_launch<true, true>(
      tokens_chain(idx, topics, doc, word, u_word, u_acc, D, W, q, prob,
                   alias, s_out, acc_out, n, n_all, k, n_cycles, alpha),
      Window{tile_first, tile_size, win, n_words},
      DocDraw{u_doc, start, length, perm, n_perm, n_docs, n_words, ka},
      stream);
}

const char* sample_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
