#!/usr/bin/env python3
"""Time variants of the warp MH kernels (``csrc/sample_warp.cu``) on one
NVIDIA card, at the NYTimes shape of ``chip_smoke.py``.

    python3 warp_variants.py [--seed S] [--tokens N]

Each variant is the source in this checkout with a few lines replaced,
built with the port's own ``nvcc`` flags into a temporary directory:

- ``as built``: the source as it is;
- ``vose rows a warp = R`` (R in 1, 2, 8): ``vose_build``'s shared-memory
  budget a block set so that each warp pairs R rows of K = 1000 at once
  (as built: 4);
- ``chain reads D, q and alias up front``: ``warp_chain`` reads D and q at
  every doc proposal and alias at every word draw before the first accept
  (as built: D and q at a doc proposal once it is accepted, alias where
  the slot is not kept);
- ``chain reads on demand``: ``warp_chain`` reads each value when its
  cycle reaches it (as built: a group of two cycles' reads first).

The state is a ``sampler="warp"``, ``format="hybrid"``, ``balance="tiles"``
trainer's first one (random topics; tiles and window as that pipeline
plans them). Every variant's table build and chain (untiled, and tiled on
the tiles that fit) must give the same bits; each is timed with CUDA
events, the variants in turns, forward then backward. Prints the card's
name and power limit first and last.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
NYT_DOCS, NYT_WORDS, NYT_TOKENS, K = 299_752, 101_636, 100_000_000, 1000

BLOCK = "constexpr int kVoseBlockBytes = 32000;"
# the chain's group loop as built (from the first marker up to the second)
LOOP = ("  for (int c0 = 0; c0 < a.n_cycles; c0 += kChainGroup) {",
        "  a.s_out[t] = s;")
# the variant that reads D and q at every doc proposal and alias at every
# word draw up front
UP_FRONT = [
    ("""      tw[g] = ud[N] < a.prob[wrow + j] ? j : a.alias[wrow + j];
      wtd[g] = a.W[wrow + td[g]];""",
     """      const float pj = a.prob[wrow + j];
      const int aj = a.alias[wrow + j];
      tw[g] = ud[N] < pj ? j : aj;
      wtd[g] = a.W[wrow + td[g]];
      dtd[g] = __int2float_rn(a.D[drow + td[g]]);
      qtd[g] = a.q[wrow + td[g]];"""),
    ("""        ds = __int2float_rn(a.D[drow + s]);
        qs = a.q[wrow + s];""",
     """        ds = dtd[g];
        qs = qtd[g];"""),
    ("""    float wtd[kChainGroup], wtw[kChainGroup], dtw[kChainGroup];""",
     """    float wtd[kChainGroup], wtw[kChainGroup], dtw[kChainGroup];
    float dtd[kChainGroup], qtd[kChainGroup];"""),
]
# the variant that reads each value when the cycle reaches it
ON_DEMAND = """  for (int c = 0; c < a.n_cycles; ++c) {
    int td;
    if (kTokens) {
      const float* u = dd.u_doc + 3 * c * N + t;
      const int slot = min(__float2int_rz(__fmul_rn(u[0], lf)),
                           max(L - 1, 0));
      const int src = dd.perm[min(max(st + slot, 0), dd.n_perm - 1)];
      require(src >= 0 && src < N);
      const int t_pos = a.topics[src];
      require(t_pos >= 0 && t_pos < k);
      const int t_unif = min(__float2int_rz(__fmul_rn(u[2 * N], kf)), k - 1);
      td = (u[N] < p_unif || L == 0) ? t_unif : t_pos;
    } else {
      td = a.t_doc[c * N + t];
    }
    const float* ua = a.u_acc + 2 * c * N + t;
    const float wtd = a.W[wrow + td];
    bool acc = __fmul_rn(ua[0], ws) < wtd;
    n_acc += acc;
    if (acc) {
      s = td;
      ws = wtd;
      ds = __int2float_rn(a.D[drow + s]);
      qs = a.q[wrow + s];
    }
    const float* ud = a.u_draw + 2 * c * N + t;
    const int j = min(__float2int_rz(__fmul_rn(ud[0], kf)), k - 1);
    const int tw = ud[N] < a.prob[wrow + j] ? j : a.alias[wrow + j];
    const float wtw = a.W[wrow + tw];
    const float dtw = __int2float_rn(a.D[drow + tw]);
    const float qtw = a.q[wrow + tw];
    const float num = __fmul_rn(__fmul_rn(__fadd_rn(dtw, a.alpha), wtw), qs);
    const float den = __fmul_rn(__fmul_rn(__fadd_rn(ds, a.alpha), ws), qtw);
    acc = __fmul_rn(ua[N], den) < num;
    n_acc += acc;
    if (acc) {
      s = tw;
      ws = wtw;
      ds = dtw;
      qs = qtw;
    }
  }
"""


def on_demand(source: str) -> list:
    start, end = (source.index(m) for m in LOOP)
    return [(source[start:end], ON_DEMAND)]


VARIANTS = {
    "as built": lambda source: [],
    "vose rows a warp = 1": lambda source: [
        (BLOCK, BLOCK.replace("32000", "8000"))],
    "vose rows a warp = 2": lambda source: [
        (BLOCK, BLOCK.replace("32000", "16000"))],
    "vose rows a warp = 8": lambda source: [
        (BLOCK, BLOCK.replace("32000", "64000"))],
    "chain reads D, q and alias up front": lambda source: UP_FRONT,
    "chain reads on demand": on_demand,
}
ENTRIES = ("vose_tables_launch", "vose_build_launch", "vose_build_slab_warps",
           "warp_chain_launch", "warp_chain_tiled_launch",
           "warp_chain_tokens_launch", "warp_chain_tokens_tiled_launch",
           "sample_warp_error_string")


def fail(msg: str):
    raise SystemExit(f"warp_variants: FAILED: {msg}")


def build_variant(name: str, edits, source: str, out: Path, like):
    """The library of ``source`` with ``edits(source)``'s (old, new) pairs
    applied, its entry points typed as ``like``'s (the port's own
    build)."""
    from repro_torch.kernels import nvcc
    for old, new in edits(source):
        if source.count(old) != 1:
            fail(f"{name}: the edit does not match the source once")
        source = source.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    src, lib = out / f"{tag}.cu", out / f"lib{tag}.so"
    src.write_text(source)
    proc = subprocess.run([nvcc._nvcc(), *nvcc._NVCC_FLAGS, "-o", str(lib),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        fail(f"{name}: nvcc: {proc.stderr[-2000:]}")
    dll = ctypes.CDLL(str(lib))
    for entry in ENTRIES:
        getattr(dll, entry).argtypes = getattr(like, entry).argtypes
        getattr(dll, entry).restype = getattr(like, entry).restype
    return dll


def cuda_ms(fn, reps: int = 3) -> float:
    for _ in range(2):
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tokens", type=int, default=NYT_TOKENS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail("no src/repro_torch beside this script")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import esca, mh
    from repro_torch.kernels import nvcc
    from repro_torch.kernels import sample_warp as sw
    from repro_torch.lda import LDAConfig, LDATrainer
    from repro_torch.lda.corpus import planted_corpus
    from repro_torch.train.lda_step import draw_warp_uniforms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    source = (nvcc.CSRC / "sample_warp.cu").read_text()
    like, _ = sw.build()
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build_variant(name, edits, source, Path(tmp), like)
                for name, edits in VARIANTS.items()}
    corpus = planted_corpus(args.seed, n_docs=NYT_DOCS, n_words=NYT_WORDS,
                            n_tokens=args.tokens, n_planted=K)
    cfg = LDAConfig(n_topics=K, sampler="warp", format="hybrid",
                    balance="tiles", fused=True, seed=args.seed)
    tr = LDATrainer(corpus, cfg, device="cuda")
    pipe = tr.fused_pipeline()
    state = tr.init_state()
    W_hat = esca.compute_w_hat(state.W, cfg.beta)
    q, scaled = mh.proposal_weights(W_hat)
    u = draw_warp_uniforms(args.seed, 0, pipe.n_tokens, cfg.mh_cycles,
                           pipe.device)
    idx, size, win = pipe.real_idx, pipe.capacity, pipe.win_words
    tiles = pipe._tiles(pipe.word_ids[idx.long()], size, win)
    idx_t = idx[tiles.fits.repeat_interleave(size)[:idx.numel()]]
    first = tiles.first[tiles.fits].contiguous()
    print(f"{corpus.n_tokens:,} tokens, K = {K}; tiles of {size} tokens, "
          f"{int(tiles.fits.sum()):,} of {tiles.fits.numel():,} fit a "
          f"{win}-word window")

    def outputs():
        return (state.topics.clone(),
                torch.zeros(pipe.n_tokens, dtype=torch.uint8,
                            device=pipe.device))

    built = sw.build
    want = None
    times: dict[str, dict[str, list]] = {n: {} for n in libs}
    try:
        for order in (list(libs), list(reversed(libs))):
            for name in order:
                lib = libs[name]
                sw.build = lambda lib=lib: (lib, "")
                tables = mh.AliasTables(*sw.vose_tables(scaled), q=q)
                streams = (state.topics, pipe.doc_ids, pipe.word_ids, *u,
                           state.D, W_hat, tables, pipe.doc_index)
                out_u, out_t = outputs(), outputs()
                untiled = lambda: sw.warp_chain_tokens(  # noqa: E731
                    idx, *streams, alpha=cfg.alpha_, out=out_u)
                tiled = lambda: sw.warp_chain_tokens_tiled(  # noqa: E731
                    idx_t, first, size, *streams, win_words=win,
                    alpha=cfg.alpha_, out=out_t)
                untiled()
                tiled()
                torch.cuda.synchronize()
                got = (*tables[:2], *out_u, *out_t)
                if want is None:
                    want = got
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    fail(f"{name}: differs from {next(iter(libs))}")
                for stage, fn in (("vose_tables", lambda: sw.vose_tables(
                        scaled)), ("chain untiled", untiled),
                        ("chain tiled", tiled)):
                    times[name].setdefault(stage, []).append(cuda_ms(fn))
    finally:
        sw.build = built
    print("ms per launch, in turns forward then backward; every variant "
          "bitwise equal:")
    for name, t in times.items():
        print(f"  {name}: " + ", ".join(
            f"{stage} {v[0]:.3f} / {v[1]:.3f}" for stage, v in t.items()))
    print(card)


if __name__ == "__main__":
    main()
