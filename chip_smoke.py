#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--tokens N] [--iters I] [--out FILE]

Phases, in order; any failure exits non-zero:

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Every kernel of the paths is built from the sources in this
   checkout (``nvcc``, one process per source, started together) and held
   to its plain-PyTorch twin on the card:
   - ``sample_fused`` at the dense path's shape (65,536 survivor tokens
     whose rows are gathered from NYTimes-sized D and Ŵ at K = 1000) and
     at edge shapes (K in {1, 2, 33, 37, 1000, 1024, 1025}, N in {1,
     129}, tied maxima, K1 the last topic, draws with u near 1), fed the
     words' K1, a1 and Q';
   - ``sample_fused_tiled`` and ``sample_sparse_tiled`` bitwise against
     their untiled kernels, and against their twins;
   - ``sample_sparse`` at edge shapes, the Q' branch finished in the
     kernel: K in {37, 1000, 1025}, L in {1, 37, 421}, rows with empty
     slots, live prefixes ending on and beside 32-slot steps, K1 absent
     from the row, u near 1, and L = 58,113 slots at K = 60,000;
   - ``vose_build`` bitwise against its twin (``mh.run_vose`` on
     ``mh.alias_queues``), with the queues built in the kernel (the main
     path's ``vose_tables``) and read (the reference's signature), on
     edge rows (all-equal weights, one dominant weight, one tiny weight;
     K in {1, 37, 1000, 1025}); ``warp_chain`` bitwise against its twin
     for topics and accepted counts (K in {1, 37, 1000, 1025}, N in {1,
     129, 4096}, uniforms within 2^-16 of 1), on the main path's streams
     with the doc proposals drawn inside (docs of one token, padding) and
     on compact streams with them given, each tiled launch bitwise
     against its untiled one.
   - the cap shapes, each just below and just past where one block's
     shared memory held its rows: the count rebuild at K = 58,100 and
     58,101 (the sorted and the any-order ``histogram`` kernel),
     ``sample_fused`` and its tiled launch at K = 25,824 and 25,825,
     both ``vose_build`` entries at K = 29,056 and 29,057, and the main
     path's chain on tables of K = 29,057.
   Masses agree within rtol 1e-5 (S' of the dense draw also within 1e-6
   of the token's total mass: it subtracts a1·b1 and can cancel); draws
   differ on at most 0.1% of tokens (of draws spread over [0, 1)), each
   within 1e-5 of the total mass of a CDF boundary (for the sparse draw:
   M, a live slot, the S'|Q' split, or a Q' topic). One fused iteration
   of the dense and the paper path on a small corpus runs on the card
   and on the CPU with the same uniforms and must agree the same way.
3. One planted corpus in the NYTimes shape (M = 299,752 docs, V =
   101,636 words, ~100 M tokens, made from the seed), and four paths on
   it, each through ``LDAEngine(corpus, LDAConfig(n_topics=1000, ...,
   fused=True, eval_every=1)).fit(I)``:
   - the dense path (``format="dense"``, ``balance="none"``);
   - the paper's configuration: ``format="hybrid"``,
     ``tail_sampler="sparse"``, ``balance="tiles"``;
   - warp_paper: ``sampler="warp"``, ``format="hybrid"``,
     ``balance="tiles"`` (the tiled chain), I iterations;
   - warp_dense: ``sampler="warp"``, ``balance="none"`` (the untiled
     chain), 2 iterations.
   Launch counts are zeroed just before each path and read just after;
   each path must launch its kernels (the ``histogram`` count rebuild
   builds every path's initial counts), keep its state on the card and
   its counts equal to the token count, and raise LLPT. The paper path's
   LLPT must stay within 0.02 of the dense path's after every iteration,
   and its tail tokens may not pile onto topic K−1. If the paper path
   sends no tile down ``sample_sparse``'s untiled route, the hybrid
   sparse path with ``balance="none"`` runs 2 iterations as well, so
   that kernel runs on a path. A warp path's share of tokens that
   accepted a proposal must lie in (0, 1) every iteration.
4. Each kernel is held to its twin, and timed against its bound, on the
   tokens its path hands it next: ``sample_fused`` on the dense path's
   next chunk, and phase 2 over all survivors with its compaction; the
   paper path's head and tail kernels (the tail's share of Q' draws
   printed, its bound counted from the live slots read); ``histogram``'s
   sorted route on the dense path's ~100 M-token W and D rebuilds, in
   turns with the any-order route and beside ``torch.bincount``, bitwise
   against both and ``index_put_``, plus a stream of split rows, and the
   any-order route on rows that overflow the tiles' windows and on an
   unsorted stream; the table build on the warp path's W̃ and the chain
   on its tokens, each beside the stages it absorbed (the queues' sort;
   the doc proposals and the gathers). One more iteration of each path is
   timed stage by stage with CUDA events.

The line before the last holds the kernels' JSON record; the last line is
the device record. Without a CUDA card, or without ``src/repro_torch``
beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM float32 outside tensor cores
NYT_DOCS, NYT_WORDS, NYT_TOKENS = 299_752, 101_636, 100_000_000
K_MAIN, N_SURVIVORS = 1000, 65_536
N_REAL = 1 << 22                   # tokens of a path held and timed
HIST_WIDE = (2_000_000, 1_000_000)  # tokens, rows: tiles span > 128 rows
HIST_SPLIT = (2_000_000, 300)      # tokens, rows: every row > BLOCK_TOKENS
MASS_RTOL, S_ATOL_FRAC = 1e-5, 1e-6
BOUNDARY_FRAC, MAX_MISMATCH_FRAC = 1e-5, 1e-3
WIDE_MISMATCH_FRAC = 0.05          # K = 60,000 sparse rows, as the card test
LLPT_GAP = 0.02                    # paper path vs dense path, bits
PAPER = dict(format="hybrid", tail_sampler="sparse", balance="tiles")
WARP_PAPER = dict(sampler="warp", format="hybrid", balance="tiles")
WARP_DENSE = dict(sampler="warp", balance="none")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok, msg: str) -> None:
    if not ok:
        fail(msg)


def import_port():
    src = ROOT / "src"
    if not (src / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(src))
    import repro_torch
    check(Path(repro_torch.__file__).resolve().is_relative_to(src),
          f"repro_torch imported from {repro_torch.__file__}, not {src}")


def counters() -> dict:
    """The launch-counted kernel wrappers, by entry (a kernel's entries,
    untiled and tiled, main path and reference signature, apart)."""
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels import sample_sparse as ss
    from repro_torch.kernels import sample_warp as sw
    return {"sample_fused": sf.sample_fused_rows,
            "sample_fused_tiled": sf.sample_fused_tiled_rows,
            "sample_sparse": ss.sample_sparse_rows,
            "sample_sparse_tiled": ss.sample_sparse_tiled_rows,
            "vose_tables": sw.vose_tables,
            "vose_build": sw.vose_build,
            "warp_chain_tokens": sw.warp_chain_tokens,
            "warp_chain_tokens_tiled": sw.warp_chain_tokens_tiled,
            "warp_chain": sw.warp_chain_rows,
            "warp_chain_tiled": sw.warp_chain_tiled_rows,
            "histogram": hist.histogram_sorted}


def zero_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """Least milliseconds for the work: bytes at the HBM rate against
    float32 operations at the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# -- phase 2: the kernels against their twins ---------------------------------

def build_kernels() -> None:
    """Every source at once: one nvcc process each."""
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels import sample_sparse as ss
    from repro_torch.kernels import sample_warp as sw
    mods = (("sample_fused.cu", sf), ("sample_sparse.cu", ss),
            ("sample_warp.cu", sw), ("histogram.cu", hist))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        logs = {name: pool.submit(mod.build) for name, mod in mods}
        logs = {name: f.result()[1] for name, f in logs.items()}
    print(f"built {', '.join(logs)} with nvcc in "
          f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())


def boundary_distance(u, d_rows, w_rows, alpha, t_a, t_b):
    """Per token, the float64 distance (fraction of the total mass) from
    the draw to the CDF boundary between topics t_a and t_b."""
    d, w = d_rows.double(), w_rows.double()
    k1 = torch.argmax(w, dim=1)
    m = w.gather(1, k1[:, None])[:, 0] * (d.gather(1, k1[:, None])[:, 0]
                                          + alpha)
    mass = (d + alpha) * w
    mass.scatter_(1, k1[:, None], 0.0)
    cum = torch.cumsum(mass, dim=1)
    total = m + cum[:, -1]
    x = u.double() * total
    lo = torch.minimum(t_a, t_b).long()
    at_sweep = (x - m - cum.gather(1, lo[:, None])[:, 0]).abs()
    is_m = (t_a.long() == k1) | (t_b.long() == k1)
    dist = torch.where(is_m, (x - m).abs(), at_sweep)
    last = w.shape[1] - 1                 # the undershoot clamp to K-1
    clamp = (t_a == last) | (t_b == last)
    dist = torch.where(clamp, torch.minimum(dist, (x - total).abs()), dist)
    return dist / total


def compare_sample_fused(fn, twin, u, doc, word, D, W_hat, alpha, label,
                         bound_count=True):
    """Kernel ``fn(u, doc, word)`` vs its twin on the same card tensors;
    ``word`` are the rows the tokens read. Returns (max |Δmass|, topic
    mismatches, max relative mass error). ``bound_count=False`` for draws
    packed at the end of the CDF, where the boundaries of the last,
    lightest topics crowd together: each mismatch must still sit at a
    boundary."""
    n = u.shape[0]
    got = fn()
    want = twin()
    torch.cuda.synchronize()
    check(got[0].shape == (n,) and bool(((got[0] >= 0)
                                         & (got[0] < D.shape[1])).all()),
          f"{label}: topics out of range")
    max_abs, max_rel = 0.0, 0.0
    for lo in range(0, n, 8192):                 # float64 rows, bounded
        sl = slice(lo, min(lo + 8192, n))
        d_rows = D[doc[sl].long()].double()
        w_rows = W_hat[word[sl].long()].double()
        total = ((d_rows + alpha) * w_rows).sum(dim=1)
        for i, name in ((1, "M"), (2, "S'"), (3, "Q'")):
            g, w = got[i][sl].double(), want[i][sl].double()
            check(bool(torch.isfinite(g).all()), f"{label}: {name} not finite")
            err = (g - w).abs()
            tol = MASS_RTOL * w.abs() + (S_ATOL_FRAC * total if i == 2 else 0)
            check(bool((err <= tol).all()),
                  f"{label}: {name} off by {float(err.max()):.3g}")
            max_abs = max(max_abs, float(err.max()))
            max_rel = max(max_rel, float((err / total).max()))
    mism = (got[0] != want[0]).nonzero().squeeze(1)
    check(not bound_count or mism.numel() <= max(1, MAX_MISMATCH_FRAC * n),
          f"{label}: {mism.numel()} topic mismatches of {n}")
    if mism.numel():
        dist = boundary_distance(u[mism], D[doc[mism].long()],
                                 W_hat[word[mism].long()], alpha,
                                 got[0][mism], want[0][mism])
        check(bool((dist <= BOUNDARY_FRAC).all()),
              f"{label}: a topic mismatch lies {float(dist.max()):.3g} of "
              "the mass from any CDF boundary")
    return max_abs, int(mism.numel()), max_rel


def sample_fused_bound_ms(u, doc, word, topics, D, in_m) -> tuple:
    """Least time for this call: distinct rows and word stats read once +
    28 B per token, against 2 flops per topic per token (Σ d·w) + 3 per
    swept topic (the CDF)."""
    n, k = u.shape[0], D.shape[1]
    words = torch.unique(word).numel()
    rows = torch.unique(doc).numel() + words
    nbytes = rows * k * 4 + words * 12 + n * 28
    swept = (topics.long() + 1)[~in_m].sum().item()
    ms, by = bound(nbytes, 2 * n * k + 3 * swept)
    return ms, by, nbytes


def fused_pair(sf, u, doc, word, D, W_hat, stats, alpha, tiles=None):
    """(kernel call, twin call) of sample_fused or, with ``tiles =
    (first, size, win)``, of sample_fused_tiled; ``stats`` are the words'
    (K1, a1, Q')."""
    if tiles is None:
        return (lambda: sf.sample_fused_rows(u, doc, word, D, W_hat, *stats,
                                             alpha=alpha),
                lambda: sf.sample_fused_rows_plain(u, doc, word, D, W_hat,
                                                   *stats, alpha=alpha))
    first, size, win = tiles
    return (lambda: sf.sample_fused_tiled_rows(
                u, doc, word, first, size, D, W_hat, *stats, win_words=win,
                alpha=alpha),
            lambda: sf.sample_fused_tiled_rows_plain(
                u, doc, word, first, size, D, W_hat, *stats, win_words=win,
                alpha=alpha))


def sorted_tiles(word, size):
    """Tile starts of a word-sorted stream and the window that fits every
    tile's run (rounded up to a power of two)."""
    first = word[::size].contiguous()
    ends = torch.clamp(torch.arange(size - 1, word.shape[0] + size - 1, size,
                                    device=word.device), max=word.shape[0] - 1)
    span = int((word[ends] - first).max()) + 1
    return first, 1 << max(span - 1, 0).bit_length()


def phase_fused_kernels(seed: int) -> dict:
    from repro_torch.core import esca
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels.ref import sample_fused_ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def counts(rows, k, density, top):
        c = torch.randint(0, top, (rows, k), generator=g, device=dev,
                          dtype=torch.int32)
        return c * (torch.rand((rows, k), generator=g, device=dev) < density)

    errs = {"sample_fused": 0.0, "sample_fused_tiled": 0.0}
    # edge shapes first: small, fast to fail; "u near 1" draws land at the
    # end of every CDF, where rounding decides between the last topics
    for k in (1, 2, 33, 37, 1000, 1024, 1025):
        for n, near_one in ((1, False), (129, False), (4096, True)):
            for ties in (False, True):
                D = counts(300, k, 0.1, 20)
                W = counts(500, k, 0.3, 50)
                if ties:
                    W[:, ::max(1, k // 3)] = 60        # tied maxima
                    W[::4] = 5                         # flat rows
                    W[1::4, -1] = 80                   # K1 the last topic
                W_hat = esca.compute_w_hat(W, 0.01)
                alpha = 50.0 / k
                stats = sf.word_stats_arrays(W_hat, alpha=alpha)
                u = torch.rand(n, generator=g, device=dev)
                if near_one:
                    u = torch.clamp(1 - u * 2.0**-16, max=1 - 2.0**-24)
                doc = torch.randint(0, 300, (n,), generator=g, device=dev,
                                    dtype=torch.int32)
                word = torch.sort(torch.randint(
                    0, 500, (n,), generator=g, device=dev,
                    dtype=torch.int32)).values
                label = (f"K={k} N={n} ties={ties} u_near_1={near_one}")
                err, _, _ = compare_sample_fused(
                    *fused_pair(sf, u, doc, word, D, W_hat, stats, alpha), u,
                    doc, word, D, W_hat, alpha, label,
                    bound_count=not near_one)
                errs["sample_fused"] = max(errs["sample_fused"], err)
                first, win = sorted_tiles(word, 128)
                win = min(win, 500)
                tiled = fused_pair(sf, u, doc, word, D, W_hat, stats, alpha,
                                   (first, 128, win))
                err, _, _ = compare_sample_fused(
                    *tiled, u, doc, word, D, W_hat, alpha,
                    "tiled " + label, bound_count=not near_one)
                errs["sample_fused_tiled"] = max(errs["sample_fused_tiled"],
                                                 err)
                a, b = tiled[0](), sf.sample_fused_rows(
                    u, doc, word, D, W_hat, *stats, alpha=alpha)
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      f"tiled {label}: sample_fused_tiled differs from "
                      "sample_fused")
    # the pre-gathered entry (the rows' own stats) against the reference's
    # oracle on those rows
    d_rows, w_rows = D[doc.long()], W_hat[word.long()]
    ids = torch.arange(doc.shape[0], dtype=torch.int32, device=dev)
    compare_sample_fused(
        lambda: sf.sample_fused(u, d_rows, w_rows, alpha=0.05),
        lambda: sample_fused_ref(u, d_rows, w_rows, alpha=0.05), u, ids, ids,
        d_rows, w_rows, 0.05, "pre-gathered rows", bound_count=False)
    print("sample_fused and sample_fused_tiled edge shapes: K in "
          "{1,2,33,37,1000,1024,1025} x N in {1,129} x tied maxima (K1 the "
          "last topic), and 4096 draws with u near 1: agree with their "
          "twins; tiled == untiled bitwise; the pre-gathered entry agrees "
          "with the reference's oracle")

    # the dense path's shape: survivors gathered from NYTimes-sized D and Ŵ
    D = counts(NYT_DOCS, K_MAIN, 0.05, 12)
    W = counts(NYT_WORDS, K_MAIN, 0.2, 40)
    W_hat = esca.compute_w_hat(W, 0.01)
    del W
    u = torch.rand(N_SURVIVORS, generator=g, device=dev)
    doc = torch.randint(0, NYT_DOCS, (N_SURVIVORS,), generator=g, device=dev,
                        dtype=torch.int32)
    word = torch.sort(torch.randint(0, NYT_WORDS, (N_SURVIVORS,),
                                    generator=g, device=dev,
                                    dtype=torch.int32)).values
    alpha = 50.0 / K_MAIN
    stats = sf.word_stats_arrays(W_hat, alpha=alpha)
    max_abs, n_mism, max_rel = compare_sample_fused(
        *fused_pair(sf, u, doc, word, D, W_hat, stats, alpha), u, doc, word,
        D, W_hat, alpha, "main-path shape")
    errs["sample_fused"] = max(errs["sample_fused"], max_abs)
    print(f"sample_fused main-path shape N={N_SURVIVORS} K={K_MAIN} from "
          f"D {tuple(D.shape)} and W_hat {tuple(W_hat.shape)}: max |dmass| "
          f"{max_abs:.3g} (max {max_rel:.3g} of the token's mass), "
          f"{n_mism} topic mismatches at CDF boundaries "
          f"(bound {int(MAX_MISMATCH_FRAC * N_SURVIVORS)})")

    ms = cuda_ms(lambda: sf.sample_fused_rows(u, doc, word, D, W_hat, *stats,
                                              alpha=alpha), reps=20)
    plain_ms = cuda_ms(lambda: sf.sample_fused_rows_plain(
        u, doc, word, D, W_hat, *stats, alpha=alpha), reps=3, warmup=1)
    topics, m, s, q = sf.sample_fused_rows(u, doc, word, D, W_hat, *stats,
                                           alpha=alpha)
    bound_ms, bound_by, nbytes = sample_fused_bound_ms(
        u, doc, word, topics, D, u * (m + s + q) < m)
    print(f"sample_fused time: kernel {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12} TB/s), "
          f"kernel at {bound_ms / ms:.1%} of its bound; single-PyTorch-call "
          "yardstick: none (no one call computes this draw)")
    del D, W_hat
    return {"errs": errs, "sample_fused": {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by}}


def sparse_case(g, K, L, n, *, M=300, V=500, near_one=False, nnz=None):
    """Packed sorted D rows with empty slots (rows fuller than L keep
    their lowest topics), Ŵ, per-word stats (K1 mostly absent from a
    token's row), and n word-sorted tokens, on the card. With ``nnz``
    row r holds its first ``nnz[r % len(nnz)]`` topics of a random row
    (live prefixes ending on or beside a 32-slot step)."""
    from repro_torch.core import esca, sparse
    dev = torch.device("cuda")
    dense = torch.randint(1, 40, (M, K), generator=g, device=dev,
                          dtype=torch.int32)
    if nnz is None:
        density = torch.rand((M, 1), generator=g, device=dev) \
            * min(1.0, L / K)
        dense = dense * (torch.rand((M, K), generator=g, device=dev)
                         < density)
    else:
        perm = torch.argsort(torch.rand((M, K), generator=g, device=dev),
                             dim=1)
        want = torch.tensor(nnz, device=dev).repeat(M // len(nnz) + 1)[:M]
        dense = dense * (torch.argsort(perm, dim=1) < want[:, None])
    packed, _ = sparse.pack_rows_sorted(dense, L)
    dense = sparse.densify_rows_sorted(packed, K)      # what the rows hold
    W = torch.randint(0, 50, (V, K), generator=g, device=dev,
                      dtype=torch.int32)
    W_hat = esca.compute_w_hat(W, 0.01)
    k1_w = torch.argmax(W_hat, dim=1).to(torch.int32)
    a1_w = W_hat.max(dim=1).values.contiguous()
    alpha = 50.0 / K
    qp_w = (alpha * (W_hat.sum(dim=1) - a1_w)).contiguous()
    doc = torch.randint(0, M, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    word = torch.sort(torch.randint(0, V, (n,), generator=g, device=dev,
                                    dtype=torch.int32)).values
    b1 = dense[doc.long(), k1_w[word.long()].long()].float()
    u = torch.rand(n, generator=g, device=dev)
    if near_one:
        u = torch.clamp(1 - u * 2.0**-16, max=1 - 2.0**-24)
    return dict(u=u, doc=doc, word=word, packed=packed, W_hat=W_hat,
                k1_w=k1_w, a1_w=a1_w, qp_w=qp_w, b1=b1, alpha=alpha)


def sparse_args(c, word=None):
    return (c["u"], c["doc"], c["word"] if word is None else word,
            c["packed"], c["W_hat"], c["k1_w"], c["a1_w"], c["qp_w"],
            c["b1"])


def sparse_bounds_dist(c, sel, word):
    """Per selected token, the float64 distance (fraction of the total
    mass) from its draw to the nearest boundary of the sparse draw: M,
    M plus the running S' mass at each live slot, M + S' (the S'|Q'
    split), M + S' plus the running Q' mass α·Ŵ'[k] at each topic, and
    the total."""
    from repro_torch.core.sparse import unpack_pairs
    v = word[sel].long()
    idx, val = unpack_pairs(c["packed"][c["doc"][sel].long()])
    k = c["W_hat"].shape[1]
    k1 = c["k1_w"][v].long()
    live = (val > 0) & (idx < k) & (idx.long() != k1[:, None])
    w = c["W_hat"][v[:, None], torch.clamp(idx, max=k - 1).long()].double()
    p = torch.where(live, val.double() * w, 0.0)
    m = c["a1_w"][v].double() * (c["b1"][sel].double() + c["alpha"])
    cum = m[:, None] + torch.cumsum(p, dim=1)
    wq = c["alpha"] * c["W_hat"][v].double()
    wq.scatter_(1, k1[:, None], 0.0)
    cum_q = cum[:, -1:] + torch.cumsum(wq, dim=1)
    total = cum[:, -1] + c["qp_w"][v].double()
    bounds = torch.cat([m[:, None], cum, cum_q, total[:, None]], dim=1)
    x = c["u"][sel].double() * total
    return (bounds - x[:, None]).abs().min(dim=1).values / total


def compare_sample_sparse(fn, twin, c, word, label,
                          max_frac=MAX_MISMATCH_FRAC):
    """Kernel vs twin on the same card tensors (``word`` are the words the
    tokens read); the main path's entries finish the Q' branch, so every
    topic lies in [0, K). At most ``max_frac`` of the draws may differ
    (None: no count bound, for draws packed at the end of the CDF), each
    at a boundary. Returns (max |ΔS'|, draw mismatches, Q' share)."""
    n = c["u"].shape[0]
    got, want = fn(), twin()
    torch.cuda.synchronize()
    k = c["W_hat"].shape[1]
    topic, needs_q, s = got
    check(bool(((topic >= 0) & (topic < k)).all()),
          f"{label}: topics out of range")
    check(bool(torch.isfinite(s).all()), f"{label}: S' not finite")
    err = (s.double() - want[2].double()).abs()
    check(bool((err <= MASS_RTOL * want[2].double().abs()).all()),
          f"{label}: S' off by {float(err.max()) if n else 0:.3g}")
    mism = ((topic != want[0]) | (needs_q != want[1])).nonzero().squeeze(1)
    check(max_frac is None or mism.numel() <= max(1, max_frac * n),
          f"{label}: {mism.numel()} draw mismatches of {n}")
    if mism.numel():
        dist = sparse_bounds_dist(c, mism, word)
        check(bool((dist <= BOUNDARY_FRAC).all()),
              f"{label}: a draw mismatch lies {float(dist.max()):.3g} of "
              "the mass from any boundary")
    q_share = float(needs_q.float().mean()) if n else 0.0
    return float(err.max()) if n else 0.0, int(mism.numel()), q_share


def sparse_pair(ss, c, tiles=None):
    args, alpha = sparse_args(c), c["alpha"]
    if tiles is None:
        return (lambda: ss.sample_sparse_rows(*args, alpha=alpha),
                lambda: ss.sample_sparse_rows_plain(*args, alpha=alpha))
    first, size, win = tiles
    return (lambda: ss.sample_sparse_tiled_rows(
                *args[:3], first, size, *args[3:], win_words=win,
                alpha=alpha),
            lambda: sparse_tiled_plain(ss, c, tiles))


def sparse_tiled_plain(ss, c, tiles):
    from repro_torch.kernels.sample_fused import window_rows
    first, size, win = tiles
    rows = window_rows(c["word"].long(), first.long(), size, win,
                       c["k1_w"].shape[0]).int()
    return ss.sample_sparse_rows_plain(*sparse_args(c, rows),
                                       alpha=c["alpha"])


def phase_sparse_kernels(seed: int) -> dict:
    from repro_torch.kernels import sample_sparse as ss
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    errs = {"sample_sparse": 0.0, "sample_sparse_tiled": 0.0}
    steps = [0, 1, 31, 32, 33, 63, 64, 65, 96, 97, 421]
    cases = [(K, L, n, near_one, None) for K in (37, 1000, 1025)
             for L in (1, 37, 421)
             for n, near_one in ((1, False), (4096, False), (4096, True))]
    cases += [(1000, 421, 4096, near_one, steps) for near_one in (False,
                                                                  True)]
    cases += [(60_000, 58_113, 96, False, [0, 33, 1000, 58_112, 58_113])]
    wide = []
    for K, L, n, near_one, nnz in cases:
        small = K > 2048
        c = sparse_case(g, K, L, n, near_one=near_one, nnz=nnz,
                        **(dict(M=5, V=8) if small else {}))
        label = (f"sparse K={K} L={L} N={n} u_near_1={near_one}"
                 + (" prefixes at 32-slot steps" if nnz else ""))
        # at K = 60,000 the boundaries lie ~1.7e-5 of the mass apart, so
        # more draws sit near one: the card test's 5% bound holds there
        max_frac = (None if near_one
                    else WIDE_MISMATCH_FRAC if small else MAX_MISMATCH_FRAC)
        err, n_mism, _ = compare_sample_sparse(
            *sparse_pair(ss, c), c, c["word"], label, max_frac)
        errs["sample_sparse"] = max(errs["sample_sparse"], err)
        first, win = sorted_tiles(c["word"], 128)
        tiles = (first, 128, min(win, c["k1_w"].shape[0]))
        pair = sparse_pair(ss, c, tiles)
        err, n_tiled, _ = compare_sample_sparse(*pair, c, c["word"],
                                                "tiled " + label, max_frac)
        errs["sample_sparse_tiled"] = max(errs["sample_sparse_tiled"], err)
        if small:
            wide.append((n_mism, n_tiled, n))
        a, b = pair[0](), ss.sample_sparse_rows(*sparse_args(c),
                                                alpha=c["alpha"])
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"tiled {label}: sample_sparse_tiled differs from "
              "sample_sparse")
    print("sample_sparse and sample_sparse_tiled edge shapes, Q' branch "
          "finished in the kernel: K in {37,1000,1025} x L in {1,37,421} "
          "x N in {1,4096}, rows with empty slots, K1 mostly absent from "
          "the row, 4096 draws with u near 1, live prefixes ending on and "
          "beside 32-slot steps, and L = 58,113 slots at K = 60,000 (past "
          "the old shared-memory cap): agree with their twins; tiled == "
          "untiled bitwise; draw mismatches at K = 60,000 (untiled, tiled, "
          f"of N): {wide} (bound {WIDE_MISMATCH_FRAC:.0%})")
    return errs


def phase_cap_shapes(seed: int) -> None:
    """Each kernel just below and just past where one block's shared
    memory held its rows, through a hand-written kernel either way: the
    count rebuild at K = 58,100 (sorted route) and 58,101 (any-order
    route), ``sample_fused`` and its tiled launch at K = 25,824 (staged)
    and 25,825 (rows read in place), both ``vose_build`` entries at K =
    29,056 and 29,057 (global memory), bitwise or against their twins,
    and the main path's chain, which has no cap, on tables of K =
    29,057."""
    from repro_torch.core import esca
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels import ops
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels.ref import histogram_ref
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 4)
    dev = torch.device("cuda")

    def ri(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    for K in (58_100, 58_101):
        n, rows_w, rows_d = 20_000, 60, 40
        word = torch.sort(ri(rows_w, (n,))).values
        doc = ri(rows_d, (n,))
        topics = ri(K, (n,))
        mask = (torch.rand(n, generator=g, device=dev) < 0.95).to(
            torch.int32)
        inv = torch.argsort(doc, stable=True).to(torch.int32)
        seg = doc[inv.long()].contiguous()
        plans = ops.count_plans(word, seg, n_docs=rows_d, n_words=rows_w,
                                n_topics=K)
        launched = (hist.histogram_sorted.launches, hist.histogram.launches)
        D, W = ops.update_counts(word, doc, topics, mask, inv, seg,
                                 n_docs=rows_d, n_words=rows_w, n_topics=K,
                                 plans=plans)
        torch.cuda.synchronize()
        route = 1 if plans == (None, None) else 0
        check(hist.histogram_sorted.launches - launched[0] == 2 * (1 - route)
              and hist.histogram.launches - launched[1] == 2 * route,
              f"count rebuild K={K}: not through the expected kernel")
        w = (mask > 0).to(torch.int32)
        check(torch.equal(W, histogram_ref(word, topics, w, n_rows=rows_w,
                                           n_topics=K))
              and torch.equal(D, histogram_ref(doc, topics, w,
                                               n_rows=rows_d, n_topics=K)),
              f"count rebuild K={K}: differs from index_put_")
    for K in (25_824, 25_825):
        for near_one in (False, True):
            D = ri(20, (40, K)) * (torch.rand((40, K), generator=g,
                                              device=dev) < 0.1)
            W_hat = esca.compute_w_hat(ri(50, (60, K)), 0.01)
            alpha = 50.0 / K
            stats = sf.word_stats_arrays(W_hat, alpha=alpha)
            n = 512
            u = torch.rand(n, generator=g, device=dev)
            if near_one:
                u = torch.clamp(1 - u * 2.0**-16, max=1 - 2.0**-24)
            doc, word = ri(40, (n,)), torch.sort(ri(60, (n,))).values
            label = f"sample_fused K={K} u_near_1={near_one}"
            compare_sample_fused(
                *fused_pair(sf, u, doc, word, D, W_hat, stats, alpha), u,
                doc, word, D, W_hat, alpha, label, bound_count=not near_one)
            first = word[::128].contiguous()
            tiled = fused_pair(sf, u, doc, word, D, W_hat, stats, alpha,
                               (first, 128, 60))
            compare_sample_fused(*tiled, u, doc, word, D, W_hat, alpha,
                                 "tiled " + label, bound_count=not near_one)
            a, b = tiled[0](), sf.sample_fused_rows(u, doc, word, D, W_hat,
                                                    *stats, alpha=alpha)
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"tiled {label}: differs from sample_fused")
    for K in (29_056, 29_057):
        check_vose(g, 40, K)
    check_tokens_chain(g, 29_057, 257, near_one=False)
    print("cap shapes: count rebuild at K = 58,100 (sorted route) and "
          "58,101 (any-order route) bitwise index_put_; sample_fused and "
          "sample_fused_tiled at K = 25,824 (staged rows) and 25,825 (rows "
          "read in place) agree with their twins, tiled == untiled "
          "bitwise; vose_build, queues built and read, at K = 29,056 "
          "(shared memory) and 29,057 (global memory) bitwise its twin; "
          "the main path's chain at K = 29,057 bitwise its twin, tiled == "
          "untiled")


def warp_weights(g, V, K, edge=True):
    """Count-shaped W̃ rows on the card; with ``edge`` the first rows are
    all equal, one dominant weight, and one tiny weight among equals."""
    dev = torch.device("cuda")
    w = torch.randint(0, 40, (V, K), generator=g, device=dev).float()
    w = w * (torch.rand((V, K), generator=g, device=dev) < 0.4) + 0.1
    if edge and V >= 3:
        w[0] = 1.0
        w[1] = 1e-3
        w[1, K // 2] = 1e3
        w[2] = 1.0
        w[2, 0] = 1e-6
    return w


def warp_chain_case(g, K, n, *, near_one=False, V=500, M=300, C=2):
    """Ids, proposals, uniforms, counts and tables of n word-sorted tokens
    on the card, for the compact-stream chain."""
    from repro_torch.kernels import sample_warp as sw
    dev = torch.device("cuda")
    tables = sw.alias_tables(warp_weights(g, V, K))
    w_hat = (tables.q * 1.01).contiguous()            # live, moved on
    D = torch.randint(0, 20, (M, K), generator=g, device=dev,
                      dtype=torch.int32)
    ri = lambda hi, shape: torch.randint(  # noqa: E731
        0, hi, shape, generator=g, device=dev, dtype=torch.int32)
    word = torch.sort(ri(V, (n,))).values
    u = torch.rand((C, 4, n), generator=g, device=dev)
    if near_one:
        u = torch.clamp(1 - u * 2.0**-16, max=1 - 2.0**-24)
    ids = (ri(K, (n,)), ri(M, (n,)), word)
    return ids, (ri(K, (C, n)), u[:, :2].contiguous(), u[:, 2:].contiguous(),
                 D, w_hat, tables)


def warp_tokens_case(g, K, n, *, near_one=False, V=500, M=300, C=2):
    """Whole-corpus streams of 2n + 37 word-sorted tokens on the card (a
    tenth padding, docs of one token, an empty doc), their doc index,
    tables and counts, and the n real tokens ``idx`` the main path's chain
    runs on: (idx, streams)."""
    from repro_torch.core import mh
    from repro_torch.kernels import sample_warp as sw
    dev = torch.device("cuda")
    ri = lambda hi, shape: torch.randint(  # noqa: E731
        0, hi, shape, generator=g, device=dev, dtype=torch.int32)
    N = 2 * n + 37
    word = torch.sort(ri(V, (N,))).values
    doc = ri(M - 3, (N,))
    doc[0], doc[-1] = M - 3, M - 2
    mask = (torch.rand(N, generator=g, device=dev) < 0.9).to(torch.int32)
    mask[0] = mask[-1] = 1
    real = mask.nonzero().squeeze(1)
    pick = torch.randperm(real.numel(), generator=g, device=dev)[:n]
    idx = torch.sort(real[pick]).values.to(torch.int32)
    u = [torch.rand((C, m, N), generator=g, device=dev) for m in (3, 2, 2)]
    if near_one:
        u = [torch.clamp(1 - x * 2.0**-16, max=1 - 2.0**-24) for x in u]
    tables = sw.alias_tables(warp_weights(g, V, K))
    return idx, (ri(K, (N,)), doc, word, *u, ri(20, (M, K)),
                 (tables.q * 1.01).contiguous(), tables,
                 mh.build_doc_index(doc, mask, M))


def tokens_out(streams):
    """Fresh outputs of the main path's chain: (topics, accepted)."""
    topics = streams[0]
    return topics.clone(), torch.zeros(topics.shape, dtype=torch.uint8,
                                       device=topics.device)


def check_vose(g, V, K) -> None:
    """Both table-build entries bitwise against their twin on edge rows."""
    from repro_torch.core import mh
    from repro_torch.kernels import sample_warp as sw
    q, scaled = mh.proposal_weights(warp_weights(g, V, K))
    queues = mh.alias_queues(scaled)
    want = mh.run_vose(scaled, *queues)
    for name, got in (("vose_tables", sw.vose_tables(scaled)),
                      ("vose_build", sw.vose_build(scaled, *queues))):
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{name} K={K}: differs from its twin")


def check_tokens_chain(g, K, n, *, near_one) -> None:
    """The main path's chain bitwise against its twin, written at idx
    only, and its tiled launch bitwise against its untiled one."""
    from repro_torch.kernels import sample_warp as sw
    idx, streams = warp_tokens_case(g, K, n, near_one=near_one)
    alpha = 50.0 / K
    label = f"warp_chain_tokens K={K} N={n} u_near_1={near_one}"
    got = sw.warp_chain_tokens(idx, *streams, alpha=alpha,
                               out=tokens_out(streams))
    want = sw.warp_chain_tokens_plain(idx, *streams, alpha=alpha,
                                      out=tokens_out(streams))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"{label}: differs from its twin")
    first, win = sorted_tiles(streams[2][idx.long()], 128)
    tiled = sw.warp_chain_tokens_tiled(idx, first, 128, *streams,
                                       win_words=min(win, 500), alpha=alpha,
                                       out=tokens_out(streams))
    check(all(torch.equal(a, b) for a, b in zip(tiled, got)),
          f"{label}: the tiled launch differs from the untiled one")


def phase_warp_kernels(seed: int) -> dict:
    """Both table-build entries and all four chain entries bitwise against
    their twins on edge shapes; each tiled chain launch bitwise against
    its untiled one."""
    from repro_torch.kernels import sample_warp as sw
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    for K in (1, 37, 1000, 1025):
        check_vose(g, 300, K)
    print("vose_build edge rows: K in {1,37,1000,1025}, all-equal, dominant "
          "and tiny weights: queues built (vose_tables) and read "
          "(vose_build), bitwise equal to its twin (mh.run_vose on "
          "mh.alias_queues)")
    for K in (1, 37, 1000, 1025):
        for n, near_one in ((1, False), (129, False), (4096, False),
                            (4096, True)):
            check_tokens_chain(g, K, n, near_one=near_one)
            ids, rest = warp_chain_case(g, K, n, near_one=near_one)
            alpha = 50.0 / K
            label = f"warp_chain K={K} N={n} u_near_1={near_one}"
            got = sw.warp_chain_rows(*ids, *rest, alpha=alpha)
            want = sw.warp_chain_rows_plain(*ids, *rest, alpha=alpha)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"{label}: differs from its twin")
            check(bool(((got[0] >= 0) & (got[0] < K)).all()),
                  f"{label}: topics out of range")
            first, win = sorted_tiles(ids[2], 128)
            tiled = sw.warp_chain_tiled_rows(*ids, first, 128, *rest,
                                             win_words=min(win, 500),
                                             alpha=alpha)
            check(all(torch.equal(a, b) for a, b in zip(tiled, got)),
                  f"{label}: the tiled launch differs from the untiled one")
    print("warp_chain edge shapes: K in {1,37,1000,1025} x N in {1,129,4096}"
          ", 4096 tokens with uniforms near 1, on the main path's streams "
          "(doc proposals inside; docs of one token, padding) and on "
          "compact streams (doc proposals given): topics and accepted "
          "counts bitwise equal to the twins; tiled == untiled bitwise")
    return {"vose_build": 0.0, "warp_chain": 0.0}


def phase_small_iterations(seed: int) -> None:
    """One fused iteration of each path on a small corpus, card vs CPU,
    same uniforms."""
    from repro_torch.core import esca
    from repro_torch.lda import LDAConfig, LDATrainer
    from repro_torch.lda.corpus import planted_corpus
    corpus = planted_corpus(seed, n_docs=400, n_words=2000, n_tokens=60_000,
                            n_planted=40, words_per_topic=40)
    for name, kw, cap in (("dense", {}, 4096), ("paper", PAPER, 128)):
        cfg = LDAConfig(n_topics=64, tile_size=1024, **kw)
        cpu = LDATrainer(corpus, cfg, device="cpu")
        gpu = LDATrainer(corpus, cfg, device="cuda")
        state = cpu.init_state()
        for _ in range(2):
            state, _ = cpu.step(state)
        u = torch.rand(cpu.n_padded_tokens,
                       generator=torch.Generator().manual_seed(seed))
        p_cpu, p_gpu = cpu.fused_pipeline(), gpu.fused_pipeline()
        fs_cpu, _, ns_cpu = p_cpu._iteration(p_cpu.from_lda_state(state), u,
                                             capacity=cap)
        fs_gpu, _, ns_gpu = p_gpu._iteration(
            p_gpu.from_lda_state(gpu.state_from_topics(state.topics, 2)),
            u.cuda(), capacity=cap)
        t_cpu, t_gpu = fs_cpu.topics, fs_gpu.topics.cpu()
        n_mism = int((t_cpu != t_gpu).sum())
        check(abs(int(ns_cpu) - int(ns_gpu)) <= 2,
              f"{name}: survivor counts differ")
        check(n_mism <= max(1, MAX_MISMATCH_FRAC * t_cpu.numel()),
              f"{name} small iteration: {n_mism} topics differ card vs CPU")
        st = p_gpu.to_lda_state(fs_gpu)
        D_ref, W_ref = esca.update_counts(
            gpu.word_ids, gpu.doc_ids, st.topics, gpu.mask,
            n_docs=gpu.n_docs, n_words=gpu.n_words, n_topics=cfg.n_topics)
        check(torch.equal(st.D, D_ref) and torch.equal(st.W, W_ref),
              f"{name}: delta-updated counts differ from the rebuild on the "
              "card")
        print(f"small fused iteration, {name} path ({corpus.n_tokens} "
              f"tokens, K=64): card vs CPU on the same uniforms: {n_mism} "
              f"topics differ, survivors {int(ns_gpu)} vs {int(ns_cpu)}, "
              "card counts == rebuild")


# -- phase 3: the paths ---------------------------------------------------------

def phase_path(corpus, label: str, kw: dict, n_iters: int, seed: int):
    """``LDAEngine.fit`` of one path, launch counts zeroed just before and
    read just after; returns (engine, record)."""
    from repro_torch.lda import LDAConfig, LDAEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = LDAConfig(n_topics=K_MAIN, eval_every=1, fused=True, seed=seed,
                    **kw)
    engine = LDAEngine(corpus, cfg)
    check(engine.device.type == "cuda", "the engine did not pick the card")
    pipe = engine.trainer.fused_pipeline()
    print(f"[{label}] engine built (tokens on the card) in "
          f"{time.perf_counter() - t0:.1f} s")

    per_iter = []
    run_fused = pipe.run_fused
    warp = kw.get("sampler") == "warp"

    def timed_run(fs, n, *args, **kwargs):  # one iteration a call here
        check(n == 1, f"[{label}] eval_every=1 should run 1 iteration a call")
        routes = dict(pipe.tile_routes)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_fused(fs, n, *args, **kwargs)    # warp: tables included
        torch.cuda.synchronize()
        st = out[1]
        per_iter.append({
            "seconds": time.perf_counter() - t,
            "accepted" if warp else "skip": float(
                (st.frac_accepted if warp else st.frac_skipped)[-1]),
            "survivors": int(out[2][-1]),
            "segments": dict(getattr(pipe, "last_survivors", {})),
            "tiles": {r: pipe.tile_routes[r] - routes[r] for r in routes},
            "win_words": pipe.win_words})
        return out

    pipe.run_fused = timed_run
    # the warp paths build neither the queues nor the doc proposals in
    # PyTorch: the kernels do
    from repro_torch.core import mh
    plain = {name: 0 for name in ("alias_queues", "doc_proposals")}
    saved = {name: getattr(mh, name) for name in plain}

    def tripwire(name):
        def call(*args, **kwargs):
            plain[name] += 1
            return saved[name](*args, **kwargs)
        return call

    zero_counts()
    t0 = time.perf_counter()
    try:
        for name in plain:
            setattr(mh, name, tripwire(name))
        hist = engine.fit(n_iters)
        torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(mh, name, fn)
    wall = time.perf_counter() - t0
    launches = read_counts()
    del pipe.run_fused
    if warp:
        check(not any(plain.values()),
              f"[{label}] the path called the plain {plain}")
        print(f"[{label}] calls of mh.alias_queues and mh.doc_proposals in "
              f"the path: {plain}")

    st = engine.state
    for name in ("topics", "D", "W"):
        check(getattr(st, name).is_cuda,
              f"[{label}] state.{name} is not on the card")
    n_real = corpus.n_tokens
    check(int(st.D.sum(dtype=torch.int64)) == n_real
          and int(st.W.sum(dtype=torch.int64)) == n_real,
          f"[{label}] count matrices do not sum to the token count")
    llpt = hist["llpt"]
    check(all(np.isfinite(llpt)), f"[{label}] LLPT not finite: {llpt}")
    check(len(llpt) >= 2 and llpt[-1] > llpt[0],
          f"[{label}] LLPT did not rise: {llpt}")
    for i, it in enumerate(per_iter, start=1):
        seg = it["segments"]
        extra = ""
        if seg:
            extra = (f", head/tail survivors {seg.get('head', 0):,}/"
                     f"{seg.get('tail', 0):,}")
        if sum(it["tiles"].values()):
            extra += (f", tiles tiled/untiled {it['tiles']['tiled']:,}/"
                      f"{it['tiles']['untiled']:,} (window "
                      f"{it['win_words']} words)")
        frac = (f"accepted fraction {it['accepted']:.4f}" if warp
                else f"skip fraction {it['skip']:.4f}")
        if warp:
            check(0.0 < it["accepted"] < 1.0,
                  f"[{label}] iteration {i}: accepted fraction "
                  f"{it['accepted']} outside (0, 1)")
        print(f"[{label}] iteration {i}: {n_real / it['seconds']:,.0f} "
              f"tokens/s ({it['seconds']:.3f} s), {frac}, survivors "
              f"{it['survivors']:,}{extra}")
    peak = torch.cuda.max_memory_allocated()
    print(f"[{label}] LLPT after iterations {hist['iteration']}: "
          f"{[round(x, 4) for x in llpt]}")
    print(f"[{label}] kernel launches in the path: {launches}")
    print(f"[{label}] fit wall {wall:.1f} s incl. {len(llpt)} LLPT evals; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    return engine, {"config": kw, "tokens": n_real, "iters": n_iters,
                    "launches": launches, "llpt": llpt,
                    "iterations": per_iter, "peak_bytes": peak,
                    "fit_wall_s": wall}


def paper_state_checks(engine, dense_llpt) -> dict:
    """The paper path against the dense path's LLPT, its tail tokens at
    K−1 against its head's, and its packed state against dense."""
    pipe = engine.trainer.fused_pipeline()
    llpt = engine.history["llpt"]
    gaps = [abs(a - b) for a, b in zip(llpt, dense_llpt)]
    check(len(llpt) == len(dense_llpt) and max(gaps) <= LLPT_GAP,
          f"paper path LLPT {llpt} is more than {LLPT_GAP} from the dense "
          f"path's {dense_llpt}")
    topics = engine.state.topics
    tail = ~pipe.head_mask & (pipe.mask > 0)
    head = pipe.head_mask & (pipe.mask > 0)
    last = K_MAIN - 1
    tail_share = float((topics[tail] == last).float().mean())
    head_share = float((topics[head] == last).float().mean())
    # comparable: at most twice the head's share plus 1/K (the reference
    # puts most tail tokens there: its empty-slot NaN)
    check(tail_share <= 2 * head_share + 1 / K_MAIN,
          f"tail tokens at topic K-1: {tail_share:.4%} against the head's "
          f"{head_share:.4%}")
    hs = pipe.from_lda_state(engine.state)
    packed, dense = hs.nbytes(), engine.state.nbytes()
    check(int(hs.overflow) == 0, "the packed state overflowed")
    print(f"[paper] LLPT gap to the dense path per iteration: "
          f"{[round(x, 5) for x in gaps]} (bound {LLPT_GAP})")
    print(f"[paper] tokens at topic K-1: tail {tail_share:.4%} of "
          f"{int(tail.sum()):,}, head {head_share:.4%} of "
          f"{int(head.sum()):,}")
    print(f"[paper] layout: v_dense {pipe.layout.v_dense:,} head words, "
          f"d_capacity {pipe.layout.d_capacity}, {len(pipe.layout.tail_caps)}"
          f" tail buckets {pipe.layout.tail_caps}; packed state "
          f"{packed / 1e9:.3f} GB against dense {dense / 1e9:.3f} GB")
    del hs
    return {"llpt_gaps": gaps, "tail_share_last_topic": tail_share,
            "head_share_last_topic": head_share, "packed_bytes": packed,
            "dense_bytes": dense, "v_dense": pipe.layout.v_dense,
            "d_capacity": pipe.layout.d_capacity}


def phase_real_chunk(engine, seed: int) -> dict:
    """sample_fused on what the dense path hands it next, from the trained
    state: the first ``capacity`` survivors in T order (the pipeline's),
    held to the twin and timed, then phase 2 over all survivors of the
    iteration and its compaction (``nonzero``), beside the reference's
    rank scatter."""
    from repro_torch.core import esca, three_branch
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.train.lda_step import draw_uniforms, survivor_indices
    pipe, cfg = engine.trainer.fused_pipeline(), engine.config
    st = engine.state
    alpha, cap, K = cfg.alpha_, pipe.capacity, st.D.shape[1]
    W_hat = esca.compute_w_hat(st.W, cfg.beta)
    stats_w = three_branch.word_stats(W_hat, g=cfg.g, alpha=alpha)
    stats = (stats_w.k[:, 0].contiguous(), stats_w.a[:, 0].contiguous(),
             stats_w.q_prime.contiguous())
    u = draw_uniforms(seed, st.iteration, pipe.n_tokens, pipe.device)
    skip = three_branch.skip_phase(u, pipe.word_ids, pipe.doc_ids, st.D,
                                   stats_w, g=cfg.g, alpha=alpha).skip

    def compact_rank():             # the reference's cumsum + scatter
        rank, n_surv = three_branch.survivor_rank(skip)
        return three_branch.compact_survivor_indices(
            rank, skip, int(n_surv)).long()

    surv = survivor_indices(skip)[0]
    check(torch.equal(surv, compact_rank()),
          "the pipeline's T-order survivors differ from the rank scatter's")
    compact_ms = cuda_ms(lambda: survivor_indices(skip), reps=3)
    rank_ms = cuda_ms(compact_rank, reps=3)
    idx = surv[:cap]
    u_c, d_c, v_c = u[idx], pipe.doc_ids[idx], pipe.word_ids[idx]
    max_abs, n_mism, _ = compare_sample_fused(
        *fused_pair(sf, u_c, d_c, v_c, st.D, W_hat, stats, alpha), u_c, d_c,
        v_c, st.D, W_hat, alpha, "dense-path chunk")

    def chunk():
        return sf.sample_fused_rows(u_c, d_c, v_c, st.D, W_hat, *stats,
                                    alpha=alpha)

    def phase2():
        for lo in range(0, surv.numel(), cap):
            i = surv[lo:lo + cap]
            sf.sample_fused_rows(u[i], pipe.doc_ids[i], pipe.word_ids[i],
                                 st.D, W_hat, *stats, alpha=alpha)

    chunk_runs = [cuda_ms(chunk, reps=3, warmup=1) for _ in range(2)]
    phase2_ms = cuda_ms(phase2, reps=1, warmup=1)
    t, m, s, q = chunk()
    ms = float(np.mean(chunk_runs))
    bound_ms, bound_by, nbytes = sample_fused_bound_ms(
        u_c, d_c, v_c, t, st.D, u_c * (m + s + q) < m)
    rows_bytes = idx.numel() * K * 8
    out = {"n_survivors": surv.numel(), "capacity": cap, "n": idx.numel(),
           "max_abs_err": max_abs, "topic_mismatches": n_mism,
           "distinct_docs": torch.unique(d_c).numel(),
           "distinct_words": torch.unique(v_c).numel(), "ms": ms,
           "runs_ms": chunk_runs, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_bytes": nbytes,
           "rows_bytes": rows_bytes, "phase2_ms": phase2_ms,
           "compact_ms": compact_ms, "compact_rank_scatter_ms": rank_ms}
    print(f"sample_fused at the dense path's chunk, T order, "
          f"N={out['n']:,} ({out['distinct_docs']:,} docs, "
          f"{out['distinct_words']:,} words): kernel {ms:.3f} ms (runs "
          f"{[round(x, 3) for x in chunk_runs]}), bound {bound_ms:.3f} ms by "
          f"{bound_by} ({nbytes / 1e9:.2f} GB of distinct rows); the kernel "
          f"moves {rows_bytes / 1e9:.1f} GB of rows, "
          f"{rows_bytes / (ms * 1e-3) / 1e12:.2f} TB/s; {n_mism} topic "
          f"mismatches at CDF boundaries, max |dmass| {max_abs:.3g}")
    print(f"phase 2 over all {surv.numel():,} survivors in chunks of "
          f"{cap:,}: {phase2_ms:.2f} ms; its compaction (nonzero) "
          f"{compact_ms:.2f} ms, the reference's rank scatter "
          f"{rank_ms:.2f} ms")
    del surv, skip, u, W_hat
    return out


def sparse_bound_ms(c, out) -> tuple:
    """Least time of the finished sparse draw on these tokens: the live
    slots of each distinct doc row read once (4 B each); Ŵ once at each
    distinct (word, topic) the work reads: the prefix of each word's row
    up to the furthest topic any of its Q' tokens drew (a finish reads up
    to its crossing), and the live slots' topics past it; 12 B of stats a
    distinct word; and 25 B of each token's own (u, doc, word, b1 read;
    topic, needs_q, S' written). Against 3 flops a live slot a token and
    2 a Q' topic swept. Returns (ms, by, bytes, text)."""
    from repro_torch.core.sparse import unpack_pairs
    packed, d, v = c["packed"], c["doc"].long(), c["word"].long()
    topic, needs_q = out[0].long(), out[1]
    nnz = (unpack_pairs(packed)[1] > 0).sum(dim=1)
    docs = torch.unique(d)
    slots = int(nnz[docs].sum())
    reach = torch.full((c["W_hat"].shape[0],), -1, dtype=torch.long,
                       device=v.device)           # furthest Q' topic read
    reach.scatter_reduce_(0, v[needs_q], topic[needs_q], "amax")
    q_entries = int((reach + 1).sum())
    k1 = c["k1_w"].long()
    pairs = []
    for lo in range(0, d.numel(), 16_384):
        idx, val = unpack_pairs(packed[d[lo:lo + 16_384]])
        vv = v[lo:lo + 16_384, None].expand_as(idx)
        keep = (val > 0) & (idx.long() != k1[vv]) & (idx.long() > reach[vv])
        pairs.append(torch.unique(vv[keep] * c["W_hat"].shape[1]
                                  + idx[keep].long()))
    w_pairs = torch.unique(torch.cat(pairs)).numel()
    words = torch.unique(v).numel()
    nbytes = 4 * slots + 4 * (w_pairs + q_entries) + 12 * words \
        + 25 * d.numel()
    live = int(nnz[d].sum())
    swept = int((topic[needs_q] + 1).sum())
    ms, by = bound(nbytes, 3 * live + 2 * swept)
    text = (f"{slots:,} live slots of {docs.numel():,} distinct doc rows "
            f"({slots / max(docs.numel(), 1):.1f} a row, of "
            f"{packed.shape[1]} slots), Ŵ at {w_pairs:,} distinct (word, "
            f"topic) pairs past the Q' prefixes and {q_entries:,} entries "
            f"in the Q' prefixes of {int((reach >= 0).sum()):,} words "
            f"(of {int((reach >= 0).sum()) * c['W_hat'].shape[1]:,} in "
            f"their whole rows); {live / d.numel():.1f} live slots a token")
    return ms, by, nbytes, text


def phase_paper_kernels(engine, seed: int) -> dict:
    """The paper path's four kernels on the tokens it hands them next:
    the first ``N_REAL`` head and tail survivors of an iteration from the
    trained state, cut into the path's tiles. Each is held to its twin,
    tiled against untiled bitwise, and timed against its bound."""
    from repro_torch.core import esca, sparse, three_branch
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.kernels import sample_sparse as ss
    from repro_torch.train.lda_step import draw_uniforms
    pipe, cfg = engine.trainer.fused_pipeline(), engine.config
    hs = pipe.from_lda_state(engine.state)
    D = sparse.densify_rows_sorted(hs.D, K_MAIN)
    W_hat = esca.compute_w_hat_from_colsum(
        pipe.layout.densify_w(hs.W_head, hs.W_tail), hs.colsum, cfg.beta)
    stats_w = three_branch.word_stats(W_hat, g=cfg.g, alpha=cfg.alpha_)
    u = draw_uniforms(seed, hs.iteration, pipe.n_tokens, pipe.device)
    dec = three_branch.skip_phase(u, pipe.word_ids, pipe.doc_ids, D,
                                  stats_w, g=cfg.g, alpha=cfg.alpha_)
    size, win, alpha = pipe.capacity, pipe.win_words, cfg.alpha_
    out = {}
    for seg, mask in (("head", pipe.head_mask), ("tail", ~pipe.head_mask)):
        idx = ((~dec.skip) & mask).nonzero().squeeze(1)[:N_REAL]
        tiles = pipe._tiles(pipe.word_ids[idx], size, win)
        fit = tiles.fits.repeat_interleave(size)[:idx.numel()]
        idx = idx[fit]
        first = tiles.first[tiles.fits].contiguous()
        u_c, d_c, v_c = u[idx], pipe.doc_ids[idx], pipe.word_ids[idx]
        n = idx.numel()
        check(n > 0, f"no {seg} tile of the paper path fits its window")
        if seg == "head":
            stats = (stats_w.k[:, 0].contiguous(),
                     stats_w.a[:, 0].contiguous(),
                     stats_w.q_prime.contiguous())
            tiled = fused_pair(sf, u_c, d_c, v_c, D, W_hat, stats, alpha,
                               (first, size, win))
            err, n_mism, _ = compare_sample_fused(
                *tiled, u_c, d_c, v_c, D, W_hat, alpha, "paper head tiles")
            untiled = fused_pair(sf, u_c, d_c, v_c, D, W_hat, stats, alpha)
            a, b = tiled[0](), untiled[0]()
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  "paper head: sample_fused_tiled differs from sample_fused")
            t, m, s, q = a
            bound_ms, bound_by, nbytes = sample_fused_bound_ms(
                u_c, d_c, v_c, t, D, u_c * (m + s + q) < m)
            names = ("sample_fused_tiled", "sample_fused")
        else:
            c = dict(u=u_c, doc=d_c, word=v_c, packed=hs.D, W_hat=W_hat,
                     k1_w=stats_w.k[:, 0].contiguous(),
                     a1_w=stats_w.a[:, 0].contiguous(),
                     qp_w=stats_w.q_prime.contiguous(), alpha=alpha)
            c["b1"] = D[d_c.long(), c["k1_w"][v_c.long()].long()].float()
            tiled = sparse_pair(ss, c, (first, size, win))
            untiled = sparse_pair(ss, c)
            err, n_mism, q_share = compare_sample_sparse(
                *tiled, c, v_c, "paper tail tiles")
            a, b = tiled[0](), untiled[0]()
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  "paper tail: sample_sparse_tiled differs from "
                  "sample_sparse")
            print(f"[paper] tail: {q_share:.2%} of the {n:,} tail tokens "
                  "fall past M + S' and take the Q' branch (finished in "
                  "the kernel)")
            bound_ms, bound_by, nbytes, read = sparse_bound_ms(c, a)
            print(f"[paper] tail: the kernel's bound counts {read}")
            names = ("sample_sparse_tiled", "sample_sparse")
        runs = {0: [], 1: []}         # tiled, untiled, untiled, tiled
        for which in (0, 1, 1, 0):
            runs[which].append(cuda_ms((tiled, untiled)[which][0], reps=5))
        ms_t, ms_u = (float(np.mean(runs[w])) for w in (0, 1))
        plain_t = cuda_ms(tiled[1], reps=1, warmup=0)
        plain_u = cuda_ms(untiled[1], reps=1, warmup=0)
        print(f"[paper] {seg}: {n:,} survivor tokens in {int(tiles.fits.sum()):,}"
              f" tiles of {size} that fit a {win}-word window: "
              f"{names[0]} {ms_t:.3f} ms, {names[1]} {ms_u:.3f} ms on the "
              f"same tokens, timed in turns (tiled {runs[0]}, untiled "
              f"{runs[1]} ms; tiled/untiled {ms_t / ms_u:.3f}); plain twins "
              f"{plain_t:.1f} / {plain_u:.1f} ms; bound {bound_ms:.3f} ms by "
              f"{bound_by} ({nbytes / 1e9:.3f} GB); kernel at "
              f"{bound_ms / ms_t:.1%} of its bound; {n_mism} draw mismatches "
              f"at boundaries, max |dmass| {err:.3g}; tiled == untiled "
              "bitwise")
        for name, ms, plain in ((names[0], ms_t, plain_t),
                                (names[1], ms_u, plain_u)):
            out[name] = {"n": n, "ms": ms, "plain_ms": plain,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bound_bytes": nbytes, "max_abs_err": err}
            if seg == "tail":
                out[name]["q_share"] = q_share
    del hs, D, W_hat, dec, u
    return out


def phase_histogram(engine, seed: int) -> dict:
    """The count rebuild at the main path's shape: W over the dense path's
    ~100 M-token word-sorted stream and D over its doc-major order through
    the sorted route (the trainer's plans), each bitwise against its twin,
    ``index_put_`` and ``torch.bincount``, and timed in turns against the
    any-order route on the same tokens (sorted, any-order, any-order,
    sorted) and beside ``torch.bincount``; then a sorted stream whose rows
    are all split over several blocks, and two streams for the any-order
    route alone: sorted rows that overflow the tiles' windows and unsorted
    D rows."""
    from repro_torch.kernels import histogram as hist
    from repro_torch.kernels.ref import histogram_ref, histogram_sorted_ref
    tr = engine.trainer
    topics = engine.state.topics
    w = (tr.mask > 0).to(torch.int32)
    inv = tr.inv_token_idx.long()
    K = K_MAIN
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 3)

    def sorted_rows(n, r):
        return torch.sort(torch.randint(0, r, (n,), generator=g,
                                        device="cuda",
                                        dtype=torch.int32)).values

    sp_rows = sorted_rows(*HIST_SPLIT)
    sp_plan = hist.plan_row_blocks(hist.row_offsets(sp_rows, HIST_SPLIT[1]),
                                   K)
    fb_rows = sorted_rows(*HIST_WIDE)
    w_plan, d_plan = tr.count_plans
    # name: (rows, topics, weights, n_rows, sorted-route plan or None)
    cases = {
        "W": (tr.word_ids, topics, w, tr.n_words, w_plan),
        "D": (tr.doc_segments, topics[inv].contiguous(),
              w[inv].contiguous(), tr.n_docs, d_plan),
        "split rows": (sp_rows, topics[:HIST_SPLIT[0]].contiguous(),
                       torch.ones_like(sp_rows), HIST_SPLIT[1], sp_plan),
        "wide rows (any order)": (fb_rows, topics[:HIST_WIDE[0]].contiguous(),
                                  torch.ones_like(fb_rows), HIST_WIDE[1],
                                  None),
        "unsorted D rows (any order)": (tr.doc_ids, topics, w, tr.n_docs,
                                        None)}
    out = {}
    for name, (rows, t, wt, n_rows, plan) in cases.items():
        def any_order():
            return hist.histogram(rows, t, wt, n_rows=n_rows, n_topics=K)

        def sorted_route():
            return hist.histogram_sorted(t, wt, plan)

        want = histogram_ref(rows, t, wt, n_rows=n_rows, n_topics=K)
        flat = (rows.long() * K + t.long())[wt > 0]
        counted = torch.bincount(flat, minlength=n_rows * K)
        routes = {"any order": any_order}
        if plan is not None:
            routes["sorted"] = sorted_route
            check(torch.equal(sorted_route(), histogram_sorted_ref(t, wt,
                                                                   plan)),
                  f"histogram {name}: the sorted route differs from its "
                  "twin")
        for route, fn in routes.items():
            got = fn()
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"histogram {name}, {route} route: differs from "
                  "index_put_")
            check(torch.equal(got.flatten().long(), counted),
                  f"histogram {name}, {route} route: differs from "
                  "torch.bincount")
            del got
        del want, counted
        n = rows.shape[0]
        runs = {r: [] for r in routes}
        turns = ("sorted", "any order", "any order", "sorted") \
            if plan is not None else ("any order",)
        for route in turns:
            runs[route].append(cuda_ms(routes[route], reps=5))
        lib_ms = cuda_ms(lambda: torch.bincount(flat, minlength=n_rows * K),
                         reps=3)
        any_ms = float(np.mean(runs["any order"]))
        any_bytes = 12 * n + n_rows * K * 4
        any_bound, _ = bound(any_bytes, n)
        rec = {"n": n, "n_rows": n_rows, "any_order_ms": any_ms,
               "any_order_runs_ms": runs["any order"],
               "any_order_bound_ms": any_bound, "library_ms": lib_ms,
               "max_abs_err": 0.0}
        line = (f"histogram {name}: {n:,} tokens into ({n_rows:,}, {K}): ")
        if plan is not None:
            ms = float(np.mean(runs["sorted"]))
            plain_ms = cuda_ms(lambda: histogram_sorted_ref(t, wt, plan),
                               reps=3)
            nbytes = 8 * n + 8 * (n_rows + 1) + 32 * plan.blocks.shape[0] \
                + 8 * plan.split_rows.numel() + n_rows * K * 4
            bound_ms, bound_by = bound(nbytes, n)
            rec.update({"ms": ms, "runs_ms": runs["sorted"],
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "bound_bytes": nbytes,
                        "blocks": plan.blocks.shape[0],
                        "split_rows": plan.split_rows.numel(),
                        "max_rows": plan.max_rows})
            line += (f"sorted route {ms:.3f} ms (runs "
                     f"{[round(x, 3) for x in runs['sorted']]}; "
                     f"{plan.blocks.shape[0]:,} blocks of at most "
                     f"{plan.max_rows} rows, {plan.split_rows.numel():,} "
                     f"split rows), bound {bound_ms:.3f} ms by {bound_by} "
                     f"({nbytes / 1e9:.2f} GB), at {bound_ms / ms:.1%} of its "
                     f"bound; twin {plain_ms:.3f} ms; ")
        line += (f"any-order route {any_ms:.3f} ms (runs "
                 f"{[round(x, 3) for x in runs['any order']]}; bound "
                 f"{any_bound:.3f} ms for its 12 B a token); torch.bincount "
                 f"{lib_ms:.3f} ms (on a precomputed flat index); bitwise "
                 "equal to index_put_ and bincount")
        print(line)
        out[name] = rec
        del flat
    return out


def chain_sectors(idx, streams, alpha) -> tuple[int, int]:
    """The random reads the main path's chain needs for the tokens
    ``idx``, replayed through its plain twin: the doc index at each doc
    (length, start), perm and topics where a doc proposal takes a token's
    topic, topics at the tokens themselves, prob at every word draw and
    alias where it is not kept, and D, Ŵ and q where the chain reads them.
    Returns (reads, distinct 32 B sectors); each distinct sector read once
    is the least the chain must move from device memory."""
    from repro_torch.core import mh
    topics, doc_ids, word_ids, u_doc, u_word, u_acc, D, W_hat, tables, \
        index = streams
    i = idx.long()
    K = W_hat.shape[1]
    addrs = []

    def rec(matrix: int, flat):
        addrs.append((matrix << 40) + flat.long() // 8)

    d, w = doc_ids[i].long(), word_ids[i].long()
    rec(5, d)
    rec(6, d)
    rec(8, i)
    L = index.length[d]
    slot = torch.minimum((u_doc[:, 0][:, i] * L.float()).to(torch.int32),
                         torch.clamp(L - 1, min=0))
    pos = torch.clamp(index.start[d][None, :] + slot, 0,
                      index.perm.shape[0] - 1).long()
    t_doc = mh.doc_proposals(u_doc[:, :, i], topics, doc_ids[i], index,
                             n_topics=K, alpha=alpha)
    ka = torch.tensor(K * alpha, dtype=torch.float32, device=L.device)
    takes_pos = ~((u_doc[:, 1][:, i] < ka / (L.float() + ka)) | (L == 0))
    rec(7, pos[takes_pos])
    rec(8, index.perm[pos[takes_pos]])
    u_draw = u_word[:, :, i]
    v = w[None, :].expand(u_draw.shape[0], -1)
    j = torch.clamp((u_draw[:, 0] * K).to(torch.int32), max=K - 1)
    rec(3, v * K + j)
    keep = u_draw[:, 1] < tables.prob[v, j.long()]
    rec(4, v[~keep] * K + j[~keep])
    t_word = torch.where(keep, j, tables.alias[v, j.long()])

    def look(matrix, mat, rows):
        def lookup(k):
            rec(matrix, rows * K + k.long())
            return mat[rows, k.long()].float()
        return lookup

    mh.mh_chain(topics[i], t_doc, t_word, u_acc[:, :, i],
                lookup_d=look(0, D, d), lookup_w=look(1, W_hat, w),
                lookup_q=look(2, tables.q, w), alpha=alpha)
    flat = torch.cat([a.flatten() for a in addrs])
    return flat.numel(), torch.unique(flat).numel()


def phase_warp_path_kernels(engine, seed: int) -> dict:
    """The warp path's kernels on its own state, each bitwise against its
    twin and timed against its bound beside the stages it absorbed: the
    table build (queues inside) on the W̃ of the NYTimes-shape counts,
    against the queues' sort + the queue-reading launch; the main path's
    chain (doc proposals inside) on the first ``N_REAL`` real tokens of
    the next iteration that fit the path's tiles, tiled against untiled,
    against ``mh.doc_proposals`` + the gathers + the compact-stream
    chain."""
    from repro_torch.core import esca, mh, sparse
    from repro_torch.kernels import sample_warp as sw
    from repro_torch.train.lda_step import draw_warp_uniforms
    pipe, cfg = engine.trainer.fused_pipeline(), engine.config
    hs = pipe.from_lda_state(engine.state)
    D = sparse.densify_rows_sorted(hs.D, K_MAIN)
    W_hat = esca.compute_w_hat_from_colsum(
        pipe.layout.densify_w(hs.W_head, hs.W_tail), hs.colsum, cfg.beta)
    V, K = W_hat.shape
    q, scaled = mh.proposal_weights(W_hat)
    q_cpu = mh.proposal_weights(W_hat.cpu())[0]
    q_rows = int((q.cpu() != q_cpu).any(dim=1).sum())
    del q_cpu
    got = sw.vose_tables(scaled)
    queues = mh.alias_queues(scaled)
    want = mh.run_vose(scaled, *queues)
    read = sw.vose_build(scaled, *queues)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "vose_tables on the warp path's W̃ differs from its twin")
    check(all(torch.equal(a, b) for a, b in zip(read, want)),
          "vose_build on the warp path's W̃ differs from its twin")
    del want, read
    runs = {0: [], 1: []}
    steps = (lambda: sw.vose_tables(scaled),
             lambda: sw.vose_build(scaled, *mh.alias_queues(scaled)))
    for which in (0, 1, 1, 0):
        runs[which].append(cuda_ms(steps[which], reps=3))
    vose_ms, before_ms = (float(np.mean(runs[w])) for w in (0, 1))
    queue_ms = cuda_ms(lambda: mh.alias_queues(scaled), reps=3)
    read_ms = cuda_ms(lambda: sw.vose_build(scaled, *queues), reps=3)
    vose_plain = cuda_ms(lambda: sw.vose_tables_plain(scaled), reps=1,
                         warmup=0)
    vbytes = 3 * V * K * 4
    v_bound, v_by = bound(vbytes, 3 * V * K)
    print(f"[warp_paper] table build on W̃ ({V:,}, {K}), queues inside "
          f"(vose_tables): {vose_ms:.3f} ms; before, the queues' sort + "
          f"the queue-reading launch: {queue_ms:.3f} + {read_ms:.3f} ms "
          f"alone, {before_ms:.3f} ms together (timed in turns: one launch "
          f"{runs[0]}, sort + launch {runs[1]} ms); twin {vose_plain:.1f} "
          f"ms; bound {v_bound:.3f} ms by {v_by} ({vbytes / 1e9:.2f} GB: "
          f"scaled read, prob and alias written), kernel at "
          f"{v_bound / vose_ms:.1%} of its bound; both entries bitwise "
          f"equal to the twin; q rows differing card vs CPU: {q_rows:,} of "
          f"{V:,}")
    tables = mh.AliasTables(prob=got[0], alias=got[1], q=q)
    del scaled, queues
    n_all, C = pipe.n_tokens, cfg.mh_cycles
    u = draw_warp_uniforms(seed, hs.iteration, n_all, C, pipe.device)
    size, win, alpha = pipe.capacity, pipe.win_words, cfg.alpha_
    idx = pipe.real_idx[:N_REAL]
    tiles = pipe._tiles(pipe.word_ids[idx.long()], size, win)
    idx = idx[tiles.fits.repeat_interleave(size)[:idx.numel()]]
    first = tiles.first[tiles.fits].contiguous()
    n = idx.numel()
    check(n > 0, "no warp tile fits its window")
    streams = (hs.topics, pipe.doc_ids, pipe.word_ids, *u, D, W_hat, tables,
               pipe.doc_index)
    out_t, out_u = tokens_out(streams), tokens_out(streams)
    tiled = lambda: sw.warp_chain_tokens_tiled(  # noqa: E731
        idx, first, size, *streams, win_words=win, alpha=alpha, out=out_t)
    untiled = lambda: sw.warp_chain_tokens(  # noqa: E731
        idx, *streams, alpha=alpha, out=out_u)
    a, b = tiled(), untiled()
    twin = sw.warp_chain_tokens_plain(idx, *streams, alpha=alpha,
                                      out=tokens_out(streams))
    i = idx.long()

    def before():
        """The route this kernel replaced: doc proposals and gathers in
        PyTorch, then the compact-stream chain."""
        t_doc = mh.doc_proposals(u[0][:, :, i], hs.topics, pipe.doc_ids[i],
                                 pipe.doc_index, n_topics=K, alpha=alpha)
        return sw.warp_chain_tiled_rows(
            hs.topics[i], pipe.doc_ids[i], pipe.word_ids[i], first, size,
            t_doc, u[1][:, :, i], u[2][:, :, i], D, W_hat, tables,
            win_words=win, alpha=alpha)

    rows = before()
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "warp_chain_tokens: the tiled launch differs from the untiled one")
    check(all(torch.equal(x, y) for x, y in zip(b, twin)),
          "warp_chain_tokens differs from its twin on the warp path's "
          "tokens")
    check(torch.equal(a[0][i], rows[0])
          and torch.equal(a[1][i].to(torch.int32), rows[1]),
          "warp_chain_tokens differs from the compact-stream chain fed "
          "mh.doc_proposals")
    t_doc = mh.doc_proposals(u[0][:, :, i], hs.topics, pipe.doc_ids[i],
                             pipe.doc_index, n_topics=K, alpha=alpha)
    gathered = (hs.topics[i], pipe.doc_ids[i], pipe.word_ids[i], first,
                size, t_doc, u[1][:, :, i].contiguous(),
                u[2][:, :, i].contiguous(), D, W_hat, tables)
    rows_chain = lambda: sw.warp_chain_tiled_rows(  # noqa: E731
        *gathered, win_words=win, alpha=alpha)
    runs = {0: [], 1: []}
    for which in (0, 1, 1, 0):
        runs[which].append(cuda_ms((tiled, untiled)[which], reps=5))
    ms_t, ms_u = (float(np.mean(runs[w])) for w in (0, 1))
    before_chain = cuda_ms(before, reps=3)
    rows_ms = cuda_ms(rows_chain, reps=5)
    del gathered, t_doc, rows
    plain = cuda_ms(lambda: sw.warp_chain_tokens_plain(
        idx, *streams, alpha=alpha, out=tokens_out(streams)), reps=1,
        warmup=0)
    reads, sectors = chain_sectors(idx, streams, alpha)
    cbytes = 32 * sectors + n * (4 + 8 + 28 * C + 5)
    c_bound, c_by = bound(cbytes, 14 * C * n)
    acc = float((a[1][i] > 0).float().mean())
    print(f"[warp_paper] warp_chain_tokens on {n:,} tokens in "
          f"{int(tiles.fits.sum()):,} tiles of {size} that fit a {win}-word "
          f"window, {C} cycles, doc proposals inside: tiled {ms_t:.3f} ms, "
          f"untiled {ms_u:.3f} ms on the same tokens, timed in turns (tiled "
          f"{runs[0]}, untiled {runs[1]} ms; tiled/untiled "
          f"{ms_t / ms_u:.3f}); before, doc proposals + gathers + the "
          f"compact-stream chain {before_chain:.3f} ms (that chain alone "
          f"{rows_ms:.3f} ms); twin {plain:.1f} ms; bound {c_bound:.3f} ms "
          f"by {c_by} ({reads / n / C:.2f} random reads a token a cycle "
          f"touching {sectors:,} distinct 32 B sectors, {cbytes / 1e9:.2f} "
          f"GB); tiled kernel at {c_bound / ms_t:.1%} of its bound; "
          f"{acc:.2%} of tokens accepted a proposal; tiled == untiled == "
          "twin == the compact-stream chain bitwise")
    print(f"[warp_paper] stage sums before -> after: table build, sort + "
          f"Vose {queue_ms:.3f} + {read_ms:.3f} = "
          f"{queue_ms + read_ms:.3f} ms -> one launch {vose_ms:.3f} ms; doc "
          f"proposals + chain on {n:,} tokens {before_chain:.3f} ms -> one "
          f"launch {ms_t:.3f} ms")
    del hs, D, W_hat, tables, u, streams, got, out_t, out_u, twin
    return {"vose_build": {"ms": vose_ms, "plain_ms": vose_plain,
                           "bound_ms": v_bound, "bound_by": v_by,
                           "queues_ms": queue_ms, "read_ms": read_ms,
                           "before_ms": before_ms, "q_rows_differ": q_rows,
                           "max_abs_err": 0.0},
            "warp_chain": {"n": n, "ms": ms_t, "untiled_ms": ms_u,
                           "before_ms": before_chain, "rows_ms": rows_ms,
                           "plain_ms": plain, "bound_ms": c_bound,
                           "bound_by": c_by, "max_abs_err": 0.0,
                           "reads_per_token_cycle": reads / n / C,
                           "distinct_sectors": sectors}}


def phase_breakdown(engine, targets, label: str) -> dict:
    """Device time of each stage of one more fused iteration.

    CUDA events are recorded around each listed function (wrapped where
    the pipeline looks it up, then restored), so the real path is what
    is timed. ``targets`` are (module, attribute, stage, inside): a
    stage's time excludes that of the stages named in ``inside`` that run
    within it. "other" is what lies between the stages."""
    spans = []

    def timed(stage, fn):
        @functools.wraps(fn)             # keeps a wrapper's launch count
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            spans.append((stage, start, stop))
            return out
        return call

    saved = [(mod, name, getattr(mod, name)) for mod, name, _, _ in targets]
    pipe = engine.trainer.fused_pipeline()
    fs = pipe.from_lda_state(engine.state)
    try:
        for (mod, name, stage, _), (_, _, fn) in zip(targets, saved):
            setattr(mod, name, timed(stage, fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.step(fs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    del fs
    stages: dict[str, float] = {}
    for stage, start, stop in spans:
        stages[stage] = stages.get(stage, 0.0) + start.elapsed_time(stop)
    for _, _, stage, inside in targets:
        for inner in inside:
            stages[stage] = stages.get(stage, 0.0) - stages.get(inner, 0.0)
    stages["other"] = wall_ms - sum(stages.values())
    print(f"[{label}] one fused iteration, {wall_ms:.1f} ms wall, by stage "
          "(CUDA events):")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.2f} ms  {ms / wall_ms:6.1%}  {name}")
    return {"wall_ms": wall_ms, "stages_ms": stages}


def warp_breakdown_targets(hybrid: bool) -> list:
    """The warp iteration's stages. The queues' sort now runs inside
    "proposal build: Vose" and the doc proposals (with the gathers that
    fed the chain) inside "chain"."""
    from repro_torch.core import mh, sparse
    from repro_torch.kernels import sample_warp
    from repro_torch.train import lda_step
    build = ("proposal build: q", "proposal build: Vose")
    t = [(lda_step, "build_warp_proposal", "proposal build: W̃", build),
         (mh, "proposal_weights", build[0], ()),
         (sample_warp, "vose_tables", build[1], ()),
         (lda_step, "draw_warp_uniforms", "uniforms", ()),
         (lda_step, "warp_chain_tokens", "chain", ()),
         (lda_step, "warp_chain_tokens_tiled", "chain", ()),
         (mh, "warp_stats", "stats", ()),
         (lda_step, "scatter_changed_deltas", "±1 scatters", ())]
    if hybrid:
        t += [(sparse, "densify_rows_sorted", "densify", ()),
              (sparse, "pack_rows_sorted", "repack", ())]
    return t


def breakdown_targets(paper: bool) -> list:
    from repro_torch.core import esca, sparse, three_branch
    from repro_torch.kernels import ops
    from repro_torch.train import lda_step
    t = [(lda_step, "draw_uniforms", "uniforms", ()),
         (esca, "compute_w_hat_from_colsum", "W_hat", ()),
         (three_branch, "word_stats", "word stats", ()),
         (three_branch, "skip_phase", "skip test", ()),
         (lda_step, "survivor_indices", "compaction", ()),
         (lda_step, "sample_fused_rows", "head sampling", ()),
         (lda_step, "sample_fused_tiled_rows", "head sampling", ()),
         (lda_step, "branch_stats", "stats", ()),
         (lda_step, "scatter_changed_deltas", "±1 scatters", ())]
    if paper:
        t += [(sparse, "densify_rows_sorted", "densify", ()),
              (sparse, "pack_rows_sorted", "repack", ()),
              (ops, "sparse_tail_draw_rows", "tail draw (Q' inside)", ())]
    return t


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=NYT_TOKENS)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every number as JSON to this file")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    import_port()
    from repro_torch.lda.corpus import planted_corpus

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    build_kernels()
    fused = phase_fused_kernels(args.seed)
    errs = {**fused["errs"], **phase_sparse_kernels(args.seed),
            **phase_warp_kernels(args.seed)}
    phase_cap_shapes(args.seed)
    phase_small_iterations(args.seed)

    if args.tokens < NYT_TOKENS:
        print(f"cut: {args.tokens:,} tokens of NYTimes' {NYT_TOKENS:,} "
              "(M, V and K kept)")
    else:
        print(f"cut: none ({args.tokens:,} tokens, M, V and K as NYTimes)")
    t0 = time.perf_counter()
    corpus = planted_corpus(args.seed, n_docs=NYT_DOCS, n_words=NYT_WORDS,
                            n_tokens=args.tokens, n_planted=K_MAIN)
    print(f"corpus: {corpus.n_tokens:,} tokens, {corpus.n_docs:,} docs, "
          f"{corpus.n_words:,} words, made in "
          f"{time.perf_counter() - t0:.1f} s")

    paths = {}
    engine, paths["dense"] = phase_path(corpus, "dense", {}, args.iters,
                                        args.seed)
    paths["dense"]["chunk"] = phase_real_chunk(engine, args.seed)
    histogram = phase_histogram(engine, args.seed)
    paths["dense"]["breakdown"] = phase_breakdown(
        engine, breakdown_targets(False), "dense")
    check(paths["dense"]["launches"]["sample_fused"] > 0,
          "the dense path launched sample_fused no time")
    del engine
    torch.cuda.empty_cache()

    engine, paths["paper"] = phase_path(corpus, "paper", PAPER, args.iters,
                                        args.seed)
    paper = paths["paper"]
    paper.update(paper_state_checks(engine, paths["dense"]["llpt"]))
    for name in ("sample_fused_tiled", "sample_sparse_tiled"):
        check(paper["launches"][name] > 0,
              f"the paper path launched {name} no time")
    paper["kernels"] = phase_paper_kernels(engine, args.seed)
    paper["breakdown"] = phase_breakdown(engine, breakdown_targets(True),
                                         "paper")
    del engine
    torch.cuda.empty_cache()
    if paper["launches"]["sample_sparse"] == 0:
        print("the paper path sent no tail tile down sample_sparse's "
              "untiled route: the hybrid sparse path with balance='none' "
              "runs it")
        kw = dict(PAPER, balance="none")
        engine, paths["hybrid_none"] = phase_path(corpus, "hybrid_none", kw,
                                                  2, args.seed)
        check(paths["hybrid_none"]["launches"]["sample_sparse"] > 0,
              "the hybrid sparse path launched sample_sparse no time")
        del engine
        torch.cuda.empty_cache()

    engine, paths["warp_paper"] = phase_path(corpus, "warp_paper", WARP_PAPER,
                                             args.iters, args.seed)
    warp = paths["warp_paper"]
    for name in ("vose_tables", "warp_chain_tokens_tiled", "histogram"):
        check(warp["launches"][name] > 0,
              f"the warp_paper path launched {name} no time")
    warp["kernels"] = phase_warp_path_kernels(engine, args.seed)
    print("the warp breakdowns below have no 'queues (sort)' and no 'doc "
          "proposals' stage: the queues are built inside 'proposal build: "
          "Vose' and the doc proposals drawn inside 'chain', which also "
          "reads the token streams in place of the gathers that 'other' "
          "held")
    warp["breakdown"] = phase_breakdown(engine, warp_breakdown_targets(True),
                                        "warp_paper")
    del engine
    torch.cuda.empty_cache()
    engine, paths["warp_dense"] = phase_path(corpus, "warp_dense", WARP_DENSE,
                                             2, args.seed)
    for name in ("vose_tables", "warp_chain_tokens", "histogram"):
        check(paths["warp_dense"]["launches"][name] > 0,
              f"the warp_dense path launched {name} no time")
    paths["warp_dense"]["breakdown"] = phase_breakdown(
        engine, warp_breakdown_targets(False), "warp_dense")
    del engine
    torch.cuda.empty_cache()
    sec = {k: [it["seconds"] for it in p["iterations"]]
           for k, p in paths.items()}
    later = {k: float(np.mean(v[1:])) for k, v in sec.items() if len(v) > 1}
    for warp_name, exact in (("warp_dense", "dense"), ("warp_paper", "paper")):
        print(f"seconds per iteration after the first, same corpus and run: "
              f"{warp_name} {later[warp_name]:.3f} s against {exact} "
              f"{later[exact]:.3f} s (exact/warp "
              f"{later[exact] / later[warp_name]:.2f}); one more iteration "
              f"split by stage: {warp_name} "
              f"{paths[warp_name]['breakdown']['wall_ms']:.1f} ms, {exact} "
              f"{paths[exact]['breakdown']['wall_ms']:.1f} ms")

    sources = {"sample_fused": ("sample_fused.cu", "sample_fused.py:202"),
               "sample_fused_tiled": ("sample_fused.cu",
                                      "sample_fused.py:251"),
               "sample_sparse": ("sample_sparse.cu", "sample_sparse.py:100"),
               "sample_sparse_tiled": ("sample_sparse.cu",
                                       "sample_sparse.py:142"),
               "vose_build": ("sample_warp.cu", "sample_warp.py:107"),
               "warp_chain": ("sample_warp.cu", "sample_warp.py:107"),
               "histogram": ("histogram.cu", "histogram.py:67")}
    # sample_fused is timed at the dense path's shape, the sparse and tiled
    # ones on the paper path's tokens, the warp kernels on the warp_paper
    # path's (the chain's tiled launch), histogram on the dense path's W
    timed = {**paper["kernels"], "sample_fused": fused["sample_fused"],
             **warp["kernels"], "histogram": histogram["W"]}
    # a kernel's entries (untiled and tiled, main path and reference
    # signature) are instantiations of its one body
    counted = {"vose_build": ("vose_tables", "vose_build"),
               "warp_chain": ("warp_chain_tokens", "warp_chain_tokens_tiled",
                              "warp_chain", "warp_chain_tiled")}
    record = {"kernels": []}
    for name, (src, ref) in sources.items():
        t = timed[name]
        launches = sum(p["launches"][c] for p in paths.values()
                       for c in counted.get(name, (name,)))
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{ref}", "launches": launches,
            "max_abs_err": max(errs.get(name, 0.0),
                               t.get("max_abs_err", 0.0)),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms")})
    print(f"launches by path: "
          f"{ {k: p['launches'] for k, p in paths.items()} }")
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s after "
          "the card check")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "paths": paths,
                                        "histogram": histogram, **record},
                                       indent=1, default=float))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
