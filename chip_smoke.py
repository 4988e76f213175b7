#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--tokens N] [--iters I] [--out FILE]

Phases, in order; any failure exits non-zero:

1. The card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Every kernel of the main path is built from the sources in this
   checkout (``nvcc``) and held to its plain-PyTorch twin on the card:
   ``sample_fused`` at the main-path shape (65,536 survivor tokens whose
   rows are gathered from NYTimes-sized D and Ŵ at K = 1000) and at edge
   shapes (K in {1, 37, 1000, 1025}, N in {1, 129}, tied maxima, draws
   with u near 1). Masses
   agree within rtol 1e-5 (S' also within 1e-6 of the token's total
   mass: it subtracts a1·b1 and can cancel); topics differ on at most
   0.1% of tokens (of draws spread over [0, 1)), each within 1e-5 of the
   total mass of a CDF boundary.
   One fused iteration on a small corpus is run on the card and on the CPU
   with the same uniforms, and must agree the same way. The kernel and the
   twin are timed with CUDA events beside the kernel's least time on the
   card (bytes at 3.35 TB/s, float32 operations at 67 TFLOP/s).
3. The main path: ``LDAEngine(corpus, LDAConfig(n_topics=1000, fused=True,
   eval_every=I)).fit(I)`` on a planted corpus in the NYTimes shape
   (M = 299,752 docs, V = 101,636 words, ~100 M tokens, made from the
   seed). Launch counts are zeroed just before and read just after; the
   run must launch every kernel of the path, keep its state on the card,
   keep the counts equal to the token count, and raise LLPT. Then the
   kernel is held to its twin, and timed, once more on the chunk of
   survivors the main path hands it next, and one more iteration is
   timed stage by stage with CUDA events.

The line before the last holds the kernels' JSON record; the last line is
the device record. Without a CUDA card, or without ``src/repro_torch``
beside this file, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM float32 outside tensor cores
NYT_DOCS, NYT_WORDS, NYT_TOKENS = 299_752, 101_636, 100_000_000
K_MAIN, N_SURVIVORS = 1000, 65_536
MASS_RTOL, S_ATOL_FRAC = 1e-5, 1e-6
BOUNDARY_FRAC, MAX_MISMATCH_FRAC = 1e-5, 1e-3


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


# -- phase 2: sample_fused against its twin -----------------------------------

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


def compare_sample_fused(sf, u, doc, word, D, W_hat, alpha, label,
                         bound_count=True):
    """Kernel vs twin on the same card tensors; returns (max |Δmass|,
    topic mismatches, max relative mass error). ``bound_count=False`` for
    draws packed at the end of the CDF, where the boundaries of the last,
    lightest topics crowd together: each mismatch must still sit at a
    boundary."""
    n = u.shape[0]
    got = sf.sample_fused_rows(u, doc, word, D, W_hat, alpha=alpha)
    want = sf.sample_fused_rows_plain(u, doc, word, D, W_hat, alpha=alpha)
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
    """Least time for this call: rows read once + 28 B per token, against
    3 flops per topic per token (phase 0) + 3 per swept topic (phase 1)."""
    n, k = u.shape[0], D.shape[1]
    rows = torch.unique(doc).numel() + torch.unique(word).numel()
    nbytes = rows * k * 4 + n * 28
    swept = (topics.long() + 1)[~in_m].sum().item()
    ops = 3 * n * k + 3 * swept
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def phase_kernels(seed: int) -> dict:
    from repro_torch.core import esca
    from repro_torch.kernels import sample_fused as sf

    t0 = time.perf_counter()
    _, log = sf.build()
    print(f"built sample_fused.cu with nvcc in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def counts(rows, k, density, top):
        c = torch.randint(0, top, (rows, k), generator=g, device=dev,
                          dtype=torch.int32)
        return c * (torch.rand((rows, k), generator=g, device=dev) < density)

    # edge shapes first: small, fast to fail; "u near 1" draws land at the
    # end of every CDF, where rounding decides between the last topics
    for k in (1, 37, 1000, 1025):
        for n, near_one in ((1, False), (129, False), (4096, True)):
            for ties in (False, True):
                D = counts(300, k, 0.1, 20)
                W = counts(500, k, 0.3, 50)
                if ties:
                    W[:, ::max(1, k // 3)] = 60        # tied maxima
                    W[::4] = 5                         # flat rows
                W_hat = esca.compute_w_hat(W, 0.01)
                u = torch.rand(n, generator=g, device=dev)
                if near_one:
                    u = torch.clamp(1 - u * 2.0**-16, max=1 - 2.0**-24)
                doc = torch.randint(0, 300, (n,), generator=g, device=dev,
                                    dtype=torch.int32)
                word = torch.randint(0, 500, (n,), generator=g, device=dev,
                                     dtype=torch.int32)
                compare_sample_fused(sf, u, doc, word, D, W_hat, 50.0 / k,
                                     f"K={k} N={n} ties={ties} "
                                     f"u_near_1={near_one}",
                                     bound_count=not near_one)
    # the pre-gathered entry point runs the same kernel
    d_rows, w_rows = D[doc.long()], W_hat[word.long()]
    a = sf.sample_fused(u, d_rows, w_rows, alpha=0.05)
    b = sf.sample_fused_rows(u, doc, word, D, W_hat, alpha=0.05)
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          "sample_fused(rows) differs from sample_fused_rows(ids)")
    print("sample_fused edge shapes: K in {1,37,1000,1025} x N in {1,129} "
          "x tied maxima, and 4096 draws with u near 1: agree with the twin")

    # the main-path shape: survivors gathered from NYTimes-sized D and Ŵ
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
    max_abs, n_mism, max_rel = compare_sample_fused(
        sf, u, doc, word, D, W_hat, alpha, "main-path shape")
    print(f"sample_fused main-path shape N={N_SURVIVORS} K={K_MAIN} from "
          f"D {tuple(D.shape)} and W_hat {tuple(W_hat.shape)}: max |dmass| "
          f"{max_abs:.3g} (max {max_rel:.3g} of the token's mass), "
          f"{n_mism} topic mismatches at CDF boundaries "
          f"(bound {int(MAX_MISMATCH_FRAC * N_SURVIVORS)})")

    ms = cuda_ms(lambda: sf.sample_fused_rows(u, doc, word, D, W_hat,
                                              alpha=alpha), reps=20)
    plain_ms = cuda_ms(lambda: sf.sample_fused_rows_plain(
        u, doc, word, D, W_hat, alpha=alpha), reps=3, warmup=1)
    topics, m, s, q = sf.sample_fused_rows(u, doc, word, D, W_hat,
                                           alpha=alpha)
    bound_ms, bound_by, nbytes = sample_fused_bound_ms(
        u, doc, word, topics, D, u * (m + s + q) < m)
    print(f"sample_fused time: kernel {ms:.4f} ms, plain twin "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({nbytes / 1e6:.1f} MB at {HBM_BYTES_PER_S / 1e12} TB/s), "
          f"kernel at {bound_ms / ms:.1%} of its bound; single-PyTorch-call "
          "yardstick: none (no one call computes this draw)")
    del D, W_hat
    return {"name": "sample_fused", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sample_fused.cu",
            "replaces": "src/repro/kernels/sample_fused.py:202",
            "launches": 0, "max_abs_err": max_abs, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


def phase_small_iteration(seed: int) -> None:
    """One fused iteration on a small corpus, card vs CPU, same uniforms."""
    from repro_torch.core import esca
    from repro_torch.lda import LDAConfig, LDATrainer
    from repro_torch.lda.corpus import planted_corpus
    corpus = planted_corpus(seed, n_docs=400, n_words=900, n_tokens=60_000,
                            n_planted=40, words_per_topic=40)
    cfg = LDAConfig(n_topics=64, tile_size=1024)
    cpu = LDATrainer(corpus, cfg, device="cpu")
    gpu = LDATrainer(corpus, cfg, device="cuda")
    state = cpu.init_state()
    for _ in range(2):
        state, _ = cpu.step(state)
    u = torch.rand(cpu.n_padded_tokens,
                   generator=torch.Generator().manual_seed(seed))
    p_cpu, p_gpu = cpu.fused_pipeline(), gpu.fused_pipeline()
    fs_cpu, _, ns_cpu = p_cpu._iteration(p_cpu.from_lda_state(state), u,
                                         capacity=4096)
    fs_gpu, _, ns_gpu = p_gpu._iteration(
        p_gpu.from_lda_state(gpu.state_from_topics(state.topics, 2)),
        u.cuda(), capacity=4096)
    t_cpu, t_gpu = fs_cpu.topics, fs_gpu.topics.cpu()
    n_mism = int((t_cpu != t_gpu).sum())
    check(abs(int(ns_cpu) - int(ns_gpu)) <= 2, "survivor counts differ")
    check(n_mism <= max(1, MAX_MISMATCH_FRAC * t_cpu.numel()),
          f"small iteration: {n_mism} topics differ card vs CPU")
    D_ref, W_ref = esca.update_counts(
        gpu.word_ids, gpu.doc_ids, fs_gpu.topics, gpu.mask,
        n_docs=gpu.n_docs, n_words=gpu.n_words, n_topics=cfg.n_topics)
    check(torch.equal(fs_gpu.D, D_ref) and torch.equal(fs_gpu.W, W_ref),
          "delta-updated counts differ from the rebuild on the card")
    print(f"small fused iteration ({corpus.n_tokens} tokens, K=64): card vs "
          f"CPU on the same uniforms: {n_mism} topics differ, survivors "
          f"{int(ns_gpu)} vs {int(ns_cpu)}, card counts == rebuild")


# -- phase 3: the main path ---------------------------------------------------

def phase_main_path(seed: int, n_tokens: int, n_iters: int) -> dict:
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.lda import LDAConfig, LDAEngine
    from repro_torch.lda.corpus import planted_corpus

    if n_tokens < NYT_TOKENS:
        print(f"cut: {n_tokens:,} tokens of NYTimes' {NYT_TOKENS:,} "
              "(M, V and K kept)")
    else:
        print(f"cut: none ({n_tokens:,} tokens, M, V and K as NYTimes)")
    t0 = time.perf_counter()
    corpus = planted_corpus(seed, n_docs=NYT_DOCS, n_words=NYT_WORDS,
                            n_tokens=n_tokens, n_planted=K_MAIN)
    print(f"corpus: {corpus.n_tokens:,} tokens, {corpus.n_docs:,} docs, "
          f"{corpus.n_words:,} words, made in "
          f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = LDAConfig(n_topics=K_MAIN, eval_every=n_iters, fused=True,
                    seed=seed)
    engine = LDAEngine(corpus, cfg)
    check(engine.device.type == "cuda", "the engine did not pick the card")
    print(f"engine built (tokens on the card) in "
          f"{time.perf_counter() - t0:.1f} s")

    pipe = engine.trainer.fused_pipeline()
    per_iter = []
    step = pipe.step

    def timed_step(fs):                  # per-iteration wall time, synced
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = step(fs)
        torch.cuda.synchronize()
        per_iter.append((time.perf_counter() - t,
                         float(out[1].frac_skipped), int(out[2])))
        return out

    pipe.step = timed_step
    sf.sample_fused_rows.launches = 0
    t0 = time.perf_counter()
    hist = engine.fit(n_iters)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sf.sample_fused_rows.launches

    st = engine.state
    for name in ("topics", "D", "W"):
        check(getattr(st, name).is_cuda, f"state.{name} is not on the card")
    n_real = corpus.n_tokens
    check(int(st.D.sum(dtype=torch.int64)) == n_real
          and int(st.W.sum(dtype=torch.int64)) == n_real,
          "count matrices do not sum to the token count")
    llpt = hist["llpt"]
    check(all(np.isfinite(llpt)), f"LLPT not finite: {llpt}")
    check(len(llpt) >= 2 and llpt[-1] > llpt[0],
          f"LLPT did not rise: {llpt}")
    check(launches > 0, "the main path launched sample_fused no time")
    for i, (dt, skip, ns) in enumerate(per_iter, start=1):
        print(f"iteration {i}: {n_real / dt:,.0f} tokens/s ({dt:.3f} s), "
              f"skip fraction {skip:.4f}, survivors {ns:,}")
    peak = torch.cuda.max_memory_allocated()
    print(f"LLPT after iteration {hist['iteration'][0]}: {llpt[0]:.4f}; "
          f"after iteration {hist['iteration'][-1]}: {llpt[-1]:.4f}")
    print(f"sample_fused launches in the main path: {launches}")
    print(f"fit wall {wall:.1f} s incl. {len(llpt)} LLPT evals; peak device "
          f"memory {peak / 2**30:.2f} GiB")
    return engine, {"tokens": n_real, "iters": n_iters, "launches": launches,
                    "llpt": llpt, "iter_seconds": [p[0] for p in per_iter],
                    "skip": [p[1] for p in per_iter],
                    "survivors": [p[2] for p in per_iter],
                    "peak_bytes": peak, "fit_wall_s": wall}


def phase_real_chunk(engine, seed: int) -> dict:
    """sample_fused on the chunk the main path hands it next: the first
    ``capacity`` survivors of an iteration from the trained state."""
    from repro_torch.core import esca, three_branch
    from repro_torch.kernels import sample_fused as sf
    from repro_torch.train.lda_step import draw_uniforms
    pipe, cfg = engine.trainer.fused_pipeline(), engine.config
    st = engine.state
    W_hat = esca.compute_w_hat(st.W, cfg.beta)
    u = draw_uniforms(seed, st.iteration, pipe.n_tokens, pipe.device)
    dec = three_branch.skip_phase(
        u, pipe.word_ids, pipe.doc_ids, st.D,
        three_branch.word_stats(W_hat, g=cfg.g, alpha=cfg.alpha_),
        g=cfg.g, alpha=cfg.alpha_)
    idx = (~dec.skip).nonzero().squeeze(1)[:pipe.capacity]
    u_c, d_c, v_c = u[idx], pipe.doc_ids[idx], pipe.word_ids[idx]
    del dec, u
    max_abs, n_mism, _ = compare_sample_fused(sf, u_c, d_c, v_c, st.D, W_hat,
                                              cfg.alpha_, "main-path chunk")
    ms = cuda_ms(lambda: sf.sample_fused_rows(u_c, d_c, v_c, st.D, W_hat,
                                              alpha=cfg.alpha_), reps=3,
                 warmup=1)
    plain_ms = cuda_ms(lambda: sf.sample_fused_rows_plain(
        u_c, d_c, v_c, st.D, W_hat, alpha=cfg.alpha_), reps=1, warmup=0)
    t, m, s, q = sf.sample_fused_rows(u_c, d_c, v_c, st.D, W_hat,
                                      alpha=cfg.alpha_)
    bound_ms, bound_by, nbytes = sample_fused_bound_ms(
        u_c, d_c, v_c, t, st.D, u_c * (m + s + q) < m)
    rows_bytes = idx.numel() * st.D.shape[1] * 8
    print(f"sample_fused at the main path's chunk N={idx.numel():,}: kernel "
          f"{ms:.3f} ms, plain twin {plain_ms:.1f} ms, bound {bound_ms:.3f} "
          f"ms by {bound_by} ({nbytes / 1e9:.2f} GB of distinct rows); the "
          f"kernel moves {rows_bytes / 1e9:.1f} GB of rows, "
          f"{rows_bytes / (ms * 1e-3) / 1e12:.2f} TB/s; {n_mism} topic "
          f"mismatches at CDF boundaries, max |dmass| {max_abs:.3g}")
    return {"n": idx.numel(), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": max_abs, "topic_mismatches": n_mism}


def phase_breakdown(engine) -> dict:
    """Device time of each stage of one more fused iteration.

    CUDA events are recorded around each function ``_iteration`` calls
    (wrapped where the pipeline looks them up, then restored), so the
    real path is what is timed; "other" is what lies between them (the
    survivor gathers and topic writes of the chunk loop)."""
    from repro_torch.core import esca, three_branch
    from repro_torch.train import lda_step
    targets = [(lda_step, "draw_uniforms"),
               (esca, "compute_w_hat_from_colsum"),
               (three_branch, "word_stats"), (three_branch, "skip_phase"),
               (three_branch, "survivor_rank"),
               (three_branch, "compact_survivor_indices"),
               (lda_step, "sample_fused_rows"), (lda_step, "branch_stats"),
               (lda_step, "scatter_changed_deltas")]
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]
    spans = []

    def timed(name, fn):
        def call(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            stop.record()
            spans.append((name, start, stop))
            return out
        return call

    pipe = engine.trainer.fused_pipeline()
    fs = pipe.from_lda_state(engine.state)
    try:
        for mod, name, fn in saved:
            setattr(mod, name, timed(name, fn))
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
    for name, start, stop in spans:
        stages[name] = stages.get(name, 0.0) + start.elapsed_time(stop)
    stages["other"] = wall_ms - sum(stages.values())
    t0 = time.perf_counter()
    engine.score()
    torch.cuda.synchronize()
    eval_ms = (time.perf_counter() - t0) * 1e3
    print(f"one fused iteration, {wall_ms:.1f} ms wall, by stage (CUDA "
          f"events); one LLPT eval {eval_ms:.1f} ms:")
    for name, ms in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.2f} ms  {ms / wall_ms:6.1%}  {name}")
    return {"wall_ms": wall_ms, "stages_ms": stages, "llpt_eval_ms": eval_ms}


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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    kernel = phase_kernels(args.seed)
    phase_small_iteration(args.seed)
    engine, main = phase_main_path(args.seed, args.tokens, args.iters)
    kernel["launches"] = main["launches"]
    main["chunk"] = phase_real_chunk(engine, args.seed)
    main["breakdown"] = phase_breakdown(engine)

    record = {"kernels": [kernel]}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "main_path": main,
                                        **record}, indent=1))
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
