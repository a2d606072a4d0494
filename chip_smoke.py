#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (h2o3_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines before the last:
  1. the card (nvidia-smi name and power limit, torch's device name) and
     the kernels' build: every csrc/*.cu compiled by nvcc for sm_90a, all
     sources at once, with each kernel's registers and the atomic
     instructions it compiled to; the f32 dense, fused and shallow-window
     kernels must show no compare-and-swap shared atomic, and no
     instantiation of the shallow-window kernel, of the int8 fused or
     int8 dense kernels' column groups, of the int8 pack kernel or of the
     non-terminal route kernel's rows per thread may spill;
  2. each kernel against its plain PyTorch version on the card (for f32
     histograms, the plain version in float64; int32 histograms must be
     equal), at small shapes and at C_pad 32 and 56 (Covertype's 54
     columns: a partial last column group in every kernel): route with
     and without the margin update at L = 64, 256 and 512; the dense
     histogram, f32 and int8, with half False and True at L = 1, 64 and
     128 and half at L = 256 and 512 (levels 8 and 9 of a depth-10 tree);
     the shallow-window histogram at L = 1 full and L = 2 and 4 half, f32
     and int8; the fused route+histogram at L_h = 2, 4 and 32, f32 and
     int8, heap ids identical; then the f32 dense, fused and
     shallow-window kernels on adversarial stats (weights up to 1e4,
     alternating-sign grads, every row in one slot and one bin, one NaN
     and one inf stat: their bins as in float64, every other bin within
     tolerance), each launched twice on the same inputs with bit-identical
     results;
  3. the main path at small size: a seeded CSV through import_file, a
     bernoulli GBM (the default configuration, then int8_hist=True),
     predict and AUC, on the card and on the CPU (plain versions), which
     must agree; then on the same CSV XGBoost, a UniformAdaptive GBM and an
     isolation forest (the same draws on both) on the adaptive engine,
     card against CPU: AUC (the forest's score AUC against the label)
     within 1e-3, no kernel launch;
  4. the multinomial path at Covertype width (581,012 rows x 54 features,
     7 classes, made on the card from a seeded torch.Generator), each run
     with its launch counts per tree and its peak memory:
       (d) GBM distribution="multinomial", depth 8 over 255 bins, 20
           iterations (140 trees) with a 100,000-row validation frame:
           probabilities sum to 1, training logloss below the class
           prior's entropy, the last history entry equal to the final
           training logloss;
       (e) (d) as 10 iterations, then a checkpoint restart to 20: its
           training and validation logloss against (d)'s, its trees that
           split as (d)'s, and a restart with too few trees refused;
     and 2 iterations of (d) with a stopwatch on each estimator stage;
       (i) a multinomial DRF at DRF's defaults (depth 20) on the same
           frame, 3 iterations of 7 class trees: training logloss at
           least 0.25 below the class prior's entropy;
     then the main path at full width on a HIGGS-shaped frame (11M rows x
     28 features, made on the card from a seeded torch.Generator), GBM of
     depth 8 over 255 bins through the estimator, each run with its launch
     counts per tree checked:
       (a) the sequential route-then-histogram path
           (radix_shallow=False, fused_level=False), 10 trees, predict
           and AUC;
       (b) the default configuration (shallow-window kernel at level 0,
           fused kernel at levels 1-5, route + dense histogram at 6-7),
           50 trees with a 1M-row validation frame and early stopping
           armed; train and validation AUC, trees built, throughput and
           peak memory;
       (c) (b) with int8_hist=True;
       (f) a binomial DRF to depth 10 on the same frame, 20 trees,
           sample_rate 0.632, mtries -1, with the validation frame: OOB
           and validation AUC, the validation series, predict timed;
     then a default-configuration run of 10 trees with a stopwatch on each
     estimator stage and each kernel wrapper, and a run (c) of 10 trees
     under torch.profiler: the share of the train() window in which the
     card is busy, and the busiest kernels; then on the adaptive engine
     (plain PyTorch: no kernel launch may count), each run with the
     seconds a tree, the deepest level and its peak memory:
       (g) XGBoost at its defaults (depth 6, eta 0.3, 256 bins), 20 trees
           with the validation frame: train and validation AUC > 0.7, the
           history's validation AUC equal to the final one, a second
           training's trees equal bit for bit; TreeSHAP of 10,000 rows
           summing to the margin within 1e-4;
       (h) DRF at H2O's defaults (depth 20, 20 bins, mtries -1, sample
           rate 0.632, min_rows 1), 10 trees: OOB AUC > 0.7;
     with one tree of (g) and one of (h) under a stopwatch on each stage
     of the adaptive engine (select, ranges, binning, histogram, split
     search, route, gamma_pass, covers), each beside its bound;
     and (j) an isolation forest at H2O's defaults (50 trees, depth 8,
     256-row samples) at the width of the credit-card fraud set (284,807
     rows x 30 columns, 492 planted anomalies): the score's AUC against the
     planted labels above a bar set from a CPU run;
  5. each kernel at the shapes of one tree of runs (a)-(d) and of levels
     8 and 9 of a run (f) tree (with its terminal route): its time from
     CUDA events beside its plain version's, one PyTorch library call's
     where there is one, and its bound (the bytes that tree's data needs,
     each input read once and each output written once, over 3.35 TB/s,
     or its f32 operations over 67 TFLOP/s, whichever is larger), and its
     agreement with the plain version on those inputs; the f32 dense and
     fused kernels also at one column per block and at the column groups
     of two shared-memory budgets, the int8 fused kernel at its column
     groups of both budgets and one column, 512 and 1024 threads, the
     shallow-window kernel (both forms) at every column group it is built
     for, 512 and 1024 threads (one window copy per warp where they fit),
     warp aggregation on and off, the int8 dense kernel at levels 6 and 7
     at each window width with its widest column group (level 7 in one
     pass or two), 512 and 1024 threads, bank padding on and off and 1, 2
     and 4 waves of blocks: each layout's result bit-identical; and the
     non-terminal route at 4 and 8 rows a thread-step and 256, 512 and
     1024 threads, heap ids identical, with the 32-byte sectors of the
     code planes its gathers touch.
The lines of runs (d)-(j) are printed again just before the two JSON
lines. The line before the last is the kernels' JSON record (the adaptive
engine adds no kernel to it); the last line is
{"ok": true, "device": {...}}. Any failed phase exits non-zero. Without a
CUDA card, or without the rest of the repository beside it, the script
exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
HIST_RTOL = 1e-4      # f32 results of sums in another order or fixed point
F_ATOL = 1e-5         # one f32 multiply-add
TPU_KERNELS = {
    "sbh_route": "h2o3_tpu/ops/hist_pallas.py:425",
    "sbh_route_emit_f": "h2o3_tpu/ops/hist_pallas.py:458",
    "sbh_hist": "h2o3_tpu/ops/hist_pallas.py:574",
    "sbh_hist_i8": "h2o3_tpu/ops/hist_pallas.py:585",
    "sbh_hist_radix": "h2o3_tpu/ops/hist_pallas.py:702",
    "sbh_route_hist_fused": "h2o3_tpu/ops/hist_pallas.py:798",
}
SOURCE = "h2o3_tpu_torch/ops/csrc/hist.cu"
HIGGS_N, HIGGS_C, HIGGS_TREES, HIGGS_DEPTH, HIGGS_NBINS = \
    11_000_000, 28, 10, 8, 255
HIGGS_VALID_N = 1_000_000
# run (b)/(c): the default configuration with early stopping armed
HIGGS_DEFAULT = dict(ntrees=50, max_depth=HIGGS_DEPTH, nbins=HIGGS_NBINS,
                     score_tree_interval=5, stopping_rounds=3,
                     stopping_metric="logloss", distribution="bernoulli",
                     seed=1)
# run (f): a binomial forest to depth 10 on the HIGGS frame, mtries -1
# (5 of 28 columns a node)
DRF_HIGGS = dict(ntrees=20, max_depth=10, nbins=HIGGS_NBINS, sample_rate=0.632,
                 mtries=-1, score_tree_interval=5, seed=1)
# runs (d) and (e): a multinomial GBM at the width of the UCI Covertype set
# (581,012 rows, 10 numeric fields, 4 + 40 one-hot wilderness and soil
# fields, 7 classes), depth 8, 20 iterations of 7 class trees
COV_N, COV_VALID_N, COV_NUM, COV_WILD, COV_SOIL = 581_012, 100_000, 10, 4, 40
COV_GBM = dict(distribution="multinomial", ntrees=20, max_depth=8,
               nbins=HIGGS_NBINS, learn_rate=0.1, score_tree_interval=5,
               seed=1)
# Covertype's class shares (covtype.data: 211,840, 283,301, 35,754, 2,747,
# 9,493, 17,367 and 20,510 rows)
COV_PRIOR = (0.3646, 0.4876, 0.0615, 0.0047, 0.0163, 0.0299, 0.0353)
# (d)'s training logloss must fall this far below the entropy of the class
# prior (where f0 starts): a CPU run of the same generator at 30,000 rows
# fell 0.66 nats in 20 iterations; a kernel that misbuilds the histograms
# leaves the model near the prior
COV_LOGLOSS_MARGIN = 0.25
# Launches per tree, worked out from the dispatch (ops/hist_cuda.py) before
# the runs: level 0 takes the shallow-window kernel (one slot, 256 bins);
# levels 1-5 the fused kernel (at most 16 left children, and the 6 MB cap
# over 4 * packed_words(C_pad) columns holds: 32 packed columns for HIGGS's
# C_pad 32, 64 for Covertype's 56); deeper levels the route and the dense
# histogram; the last level the terminal route.
PER_TREE = {
    "sequential": {"hist": 8, "route": 7, "route_f": 1},
    "default": {"radix": 1, "fused": 5, "route": 2, "hist": 2, "route_f": 1},
    "int8": {"radix": 1, "fused": 5, "route": 2, "hist_i8": 2, "route_f": 1},
    # (d), (e): depth 8 at C_pad 56, as the default configuration
    "multinomial": {"radix": 1, "fused": 5, "route": 2, "hist": 2,
                    "route_f": 1},
    # (f): depth 10, levels 6-9 on the route and dense histogram
    "drf10": {"radix": 1, "fused": 5, "route": 4, "hist": 4, "route_f": 1},
}


# runs (g)-(j), the adaptive engine (no kernel of ops/csrc on its path):
# (g) XGBoost at its own defaults as the estimator sets them (depth 6,
# eta 0.3, 256 bins, reg_lambda 1, min_child_weight 1), 20 trees on the
# HIGGS frame with its validation frame
XGB_HIGGS = dict(ntrees=20, max_depth=6, nbins=256, seed=1,
                 score_tree_interval=5)
XGB_SHAP_ROWS = 10_000
# (h) DRF at H2O's defaults on the HIGGS frame (mtries -1: 5 of 28), 10
# trees
DRF_DEEP = dict(ntrees=10, max_depth=20, nbins=20, mtries=-1,
                sample_rate=0.632, min_rows=1, seed=1, score_tree_interval=5)
# (i) multinomial DRF at DRF's defaults (depth 20) on the Covertype frame,
# 3 iterations of 7 class trees
COV_DRF = dict(ntrees=3, max_depth=20, nbins=20, seed=1)
# (j) an isolation forest at H2O's defaults at the width of the Kaggle
# credit-card fraud set (Dal Pozzolo et al. 2015: 284,807 rows x 30
# columns, 492 frauds): N(0,1) inliers, and 492 planted anomalies shifted
# by ISO_SHIFT in ISO_SHIFT_COLS seeded columns
CC_N, CC_C, CC_ANOM = 284_807, 30, 492
ISO_SHIFT, ISO_SHIFT_COLS = 2.5, 6
ISO = dict(ntrees=50, max_depth=8, sample_size=256, nbins=20, seed=1)
# the score's AUC against the planted labels must pass this: a CPU run of
# the same generator (torch's CPU generator, seed 11) at this size, through
# the port on the CPU, gave ISO_AUC_CPU; the card's generator draws other
# numbers, and an isolation forest that splits at random scores 0.5
ISO_AUC_CPU = 0.855526
ISO_AUC_BAR = 0.80
# the adaptive engine's stages, as its functions (engine.py)
STAGES = (("select", "in_sample_rows"), ("ranges", "_ranges"),
          ("binning", "bin_rows"), ("histogram", "build_histograms"),
          ("split search", "find_best_splits"), ("route", "route_rows"),
          ("gamma_pass", "gamma_pass"), ("covers", "node_covers"))


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


LOG = []
# the lines of runs (d)-(f) and of their kernels' timings, printed again
# just before the result so that the end of the output holds them
RECAP = re.compile(r"(covtype|drf \(f\)|kernel time of (one tree, run "
                   r"\(d\)|levels 8-9)|timing .*(C=56|\(level [89]\))|"
                   r"xgboost \(g\)|drf \(h\)|isolation forest \(j\)|"
                   r"adaptive)")


def say(msg):
    LOG.append(msg)
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
def phase_card(torch, _build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    say(f"card: {card}")
    say(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    say(f"build: {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry function" \
                    in line:
                say(f"ptxas {name}: {line.strip()}")
        # the shallow-window kernel, the int8 kernels' column groups and
        # the route's rows per thread are unrolled at compile time: none
        # of them may spill
        for fn, spilled in ptxas_spills(log).items():
            if re.search(r"radix_kernel|fused_i8_kernel|hist_i8_kernel|"
                         r"pack_i8_kernel|route_rows_kernel", fn):
                check(not spilled, f"{fn} spills: {spilled} bytes")
    ops = {}
    for name in logs:
        ops.update(sass_atomics(_build, name))
    # the f32 kernels sum in fixed point: no shared atomic of theirs may be
    # a compare-and-swap loop (the f64 adds they replace compiled to
    # ATOMS.CAST.SPIN.64)
    f32 = {fn: found for fn, found in ops.items()
           if re.search(r"(hist|fused|radix)_kernelIf", fn)}
    for kind in ("hist", "fused", "radix"):
        check(any(f"{kind}_kernelIf" in fn for fn in f32),
              f"f32 {kind} kernel not found in the SASS: {sorted(ops)}")
    for fn, found in f32.items():
        cas = sorted(op for op in found if op.startswith("ATOMS.CAS"))
        check(not cas, f"{fn} compiled a compare-and-swap shared atomic: "
              f"{cas}")
    say(f"sass: {len(f32)} f32 histogram kernels, no compare-and-swap "
        "shared atomic")
    return card


def ptxas_spills(log):
    """{function: spill store + load bytes} from nvcc's -Xptxas -v log."""
    fn, out = None, {}
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn] = int(m.group(1)) + int(m.group(2))
    return out


def sass_atomics(_build, name):
    """Print the atomic instructions each kernel of a built library
    compiled to, from cuobjdump -sass: shared-memory ATOMS.* (an add done
    as a compare-and-swap loop shows as ATOMS.CAS*, a native one as
    ATOMS.ADD*) and global RED.* / ATOM.*. Returns {function: set of
    ops}."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    check(os.path.isfile(tool), f"cuobjdump not found beside nvcc: {tool}")
    sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, timeout=120)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr}")
    fn, ops = None, {}
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            ops[fn] = set()
        elif fn:
            m = re.search(r"\b(ATOMS|RED|ATOM)\.([A-Z0-9_.]+)", line)
            if m:
                ops[fn].add(f"{m.group(1)}.{m.group(2)}")
    for fn, found in ops.items():
        if found:
            say(f"sass {name} {fn}: {{{', '.join(sorted(found))}}}")
    return ops


def _codes_heap_stats(torch, dev, seed, *, n, c_pad, b_val, L, int8=False):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n)).astype(np.uint8)
    codes[rng.random((c_pad, n)) < 0.05] = b_val
    codes[-2:] = 0                     # padding columns: every row in bin 0
    base = L - 1
    heap = rng.integers(base, base + L, n).astype(np.int32)
    heap[rng.random(n) < 0.1] = max(0, base - 1)
    stats = rng.normal(0, 1, (4, n)).astype(np.float32)
    stats[3] = 0.0
    if int8:
        stats = np.clip(np.round(stats * 40.0), -127, 127).astype(np.int32)
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(heap).to(dev),
            torch.from_numpy(stats).to(dev), base)


def _route_tables(torch, dev, seed, L, c_pad, n_bins):
    rng = np.random.default_rng(seed)
    lp = max(8, L)
    tbl = np.zeros((8, lp), np.float32)
    tbl[0, :L] = rng.integers(0, c_pad, L)
    tbl[1, :L] = rng.random(L) < 0.8
    route_f = (rng.random((lp, n_bins)) < 0.5).astype(np.float32)
    return torch.from_numpy(tbl).to(dev), torch.from_numpy(route_f).to(dev)


def hist_rel_err(got, want):
    """max |got - want| per stat row over that row's max |want|."""
    errs = []
    for s in range(got.shape[2]):
        scale = max(want[:, :, s].abs().max().item(), 1e-30)
        errs.append((got[:, :, s] - want[:, :, s]).abs().max().item() / scale)
    return max(errs)


def phase_kernels_small(torch, HC, dev, c_pad):
    n, n_bins, b_val = 1 << 16, 256, 255
    # L = 256 and 512: the levels 8 and 9 of a depth-10 tree (route tables
    # of 256 and 512 leaves, the dense histograms in passes of 64 slots)
    for L in (64, 256, 512):
        for emit_f in (False, True):
            codes, heap, _, base = _codes_heap_stats(torch, dev, 1, n=n,
                                                     c_pad=c_pad,
                                                     b_val=b_val, L=L)
            rng = np.random.default_rng(2)
            tbl = np.zeros((8, L), np.float32)
            tbl[0] = rng.integers(0, c_pad, L)
            tbl[1] = rng.random(L) < 0.8
            route_f = (rng.random((L, n_bins)) < 0.5).astype(np.float32)
            nodes_p = -(-(2 * (base + L) + 1) // 128) * 128
            valtab = np.zeros((8, nodes_p), np.float32)
            valtab[0] = rng.normal(0, 1, nodes_p)
            F = rng.normal(0, 1, n).astype(np.float32)
            args = [codes, heap] + [torch.from_numpy(a).to(dev)
                                    for a in (tbl, route_f, valtab, F)]
            kw = dict(base=base, L=L, eta=0.1, emit_f=emit_f)
            h_k, f_k = HC.sbh_route(*args, **kw)
            h_p, f_p = HC.sbh_route_plain(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(h_k, h_p),
                  f"route emit_f={emit_f} L={L} C={c_pad}: heap differs")
            ferr = (f_k - f_p).abs().max().item() if emit_f else 0.0
            check(ferr < F_ATOL, f"route emit_f={emit_f} L={L} C={c_pad}: "
                  f"F err {ferr}")
            say(f"kernel route emit_f={emit_f} L={L} n={n} C={c_pad}: heap "
                f"identical, F max err {ferr:.3g} (tol {F_ATOL})")
    for L, half in ((1, False), (1, True), (64, False), (64, True),
                    (128, False), (128, True), (256, True), (512, True)):
        for int8 in (False, True):
            codes, heap, stats, base = _codes_heap_stats(
                torch, dev, 10 + L, n=n, c_pad=c_pad, b_val=b_val, L=L,
                int8=int8)
            kw = dict(base=base, L=L, n_bins=n_bins, half=half)
            got = HC.sbh_hist_dense(codes, heap, stats, int8=int8, **kw)
            check_hist(torch, HC, f"hist int8={int8} L={L} half={half} "
                       f"n={n} C={c_pad}", got, codes, heap, stats, kw, int8)
    for L, half in ((1, False), (2, True), (4, True)):
        for int8 in (False, True):
            codes, heap, stats, base = _codes_heap_stats(
                torch, dev, 20 + L, n=n, c_pad=c_pad, b_val=b_val, L=L,
                int8=int8)
            kw = dict(base=base, L=L, n_bins=n_bins, half=half)
            got = HC.sbh_hist_radix(codes, heap, stats, int8=int8, **kw)
            check_hist(torch, HC, f"radix int8={int8} L={L} half={half} "
                       f"n={n} C={c_pad}", got, codes, heap, stats, kw, int8)
    for L_h in (2, 4, 32):
        for int8 in (False, True):
            L_r = L_h // 2
            codes, heap, stats, base_r = _codes_heap_stats(
                torch, dev, 30 + L_h, n=n, c_pad=c_pad, b_val=b_val, L=L_r,
                int8=int8)
            tbl, route_f = _route_tables(torch, dev, 31 + L_h, L_r, c_pad,
                                         n_bins)
            kw = dict(base_r=base_r, L_r=L_r, base_h=L_h - 1, L_h=L_h,
                      n_bins=n_bins)
            h_k, got = HC.sbh_route_hist_fused(codes, heap, tbl, route_f,
                                               stats, int8=int8, **kw)
            check_fused(torch, HC, f"fused int8={int8} L_h={L_h} n={n} "
                        f"C={c_pad}",
                        h_k, got, (codes, heap, tbl, route_f, stats), kw, int8)


def _adversarial(torch, dev, seed, *, n, c_pad, b_val, L, one_bin=False,
                 nonfinite=False):
    """Stats that stress a fixed-point sum: weights up to 1e4, grads of
    alternating sign (the first half of the rows in pairs that cancel
    exactly), hess a fraction of the weight. one_bin puts every row in the
    window's first slot and every code in one bin; nonfinite makes one
    grad NaN and one hess +inf, in rows of the window."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n)).astype(np.uint8)
    codes[-2:] = 0
    base = L - 1
    heap = rng.integers(base, base + L, n).astype(np.int32)
    if one_bin:
        codes[:] = 7
        heap[:] = base
    w = rng.uniform(0.0, 1e4, n)
    g = w * rng.uniform(0.5, 1.5, n)
    g[1: n // 2: 2] = g[0: n // 2 - 1: 2]
    g[1::2] *= -1.0
    stats = np.stack([w, g, w * rng.uniform(0.05, 0.25, n),
                      np.zeros(n)]).astype(np.float32)
    if nonfinite:
        stats[1, 10] = np.nan
        stats[2, 21] = np.inf
        heap[[10, 21]] = base            # leaf 0: slot 0 of a half window
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(heap).to(dev),
            torch.from_numpy(stats).to(dev), base)


def bit_equal(torch, a, b):
    """Equal bit for bit (NaN included) and of one shape."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def check_adversarial(torch, what, got, again, want, nonfinite):
    """Hold an f32 histogram of adversarial stats to the float64 plain
    version: bins the plain version makes NaN or +-inf equal (and present
    where the stats hold a NaN and an inf), every other bin within
    HIST_RTOL of its stat row's scale; and a second launch on the same
    inputs bit-identical to the first."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    check(bit_equal(torch, got, again), f"{what}: two launches differ")
    fin = torch.isfinite(want)
    check(bool((~fin).any()) == nonfinite, f"{what}: "
          f"{int((~fin).sum())} non-finite bins in the plain version")
    check(torch.equal(fin, torch.isfinite(got)), f"{what}: non-finite bins "
          f"differ ({int((~fin).sum())} in the plain version)")
    check(torch.equal(torch.isnan(want), torch.isnan(got)),
          f"{what}: NaN bins differ")
    inf = torch.isinf(want)
    check(torch.equal(got[inf].double(), want[inf]), f"{what}: inf bins "
          "differ")
    zero = torch.zeros((), dtype=torch.float64, device=want.device)
    err = hist_rel_err(torch.where(fin, got.double(), zero),
                       torch.where(fin, want, zero))
    check(err <= HIST_RTOL, f"{what}: rel err {err}")
    say(f"kernel {what}: rel err {err:.3g} (tol {HIST_RTOL}), "
        f"{int((~fin).sum())} non-finite bins as in f64, two launches "
        "bit-identical")
    return err


def phase_adversarial(torch, HC, dev, c_pad):
    n, n_bins, b_val = 1 << 16, 256, 255
    cases = (("one slot, one bin", 1, dict(one_bin=True)),
             ("L=64 half", 64, {}),
             ("L=64 half, NaN and inf", 64, dict(nonfinite=True)),
             ("L=512 half", 512, {}))
    for what, L, extra in cases:
        codes, heap, stats, base = _adversarial(torch, dev, 60 + L, n=n,
                                                c_pad=c_pad, b_val=b_val,
                                                L=L, **extra)
        kw = dict(base=base, L=L, n_bins=n_bins, half=L > 1)
        got, again = (HC.sbh_hist_dense(codes, heap, stats, **kw)
                      for _ in range(2))
        want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
        check_adversarial(torch, f"hist adversarial {what} n={n} "
                          f"C={c_pad}", got, again, want, "nonfinite" in extra)
    for what, L_h, extra in (("every row to one slot, one bin", 2,
                              dict(one_bin=True)),
                             ("L_h=32", 32, {}),
                             ("L_h=32, NaN and inf", 32,
                              dict(nonfinite=True))):
        L_r = L_h // 2
        codes, heap, stats, base_r = _adversarial(torch, dev, 70 + L_h, n=n,
                                                  c_pad=c_pad, b_val=b_val,
                                                  L=L_r, **extra)
        tbl, route_f = _route_tables(torch, dev, 71 + L_h, L_r, c_pad, n_bins)
        if extra:
            tbl[1, 0] = 1.0               # leaf 0 splits, every row left
            route_f[0] = 0.0
        kw = dict(base_r=base_r, L_r=L_r, base_h=L_h - 1, L_h=L_h,
                  n_bins=n_bins)
        (h_k, got), (h_2, again) = (
            HC.sbh_route_hist_fused(codes, heap, tbl, route_f, stats, **kw)
            for _ in range(2))
        h_p, want = HC.sbh_route_hist_plain(codes, heap, tbl, route_f,
                                            stats.double(), **kw)
        torch.cuda.synchronize()
        check(torch.equal(h_k, h_p) and torch.equal(h_k, h_2),
              f"fused adversarial {what}: heap differs")
        check_adversarial(torch, f"fused adversarial {what} n={n} "
                          f"C={c_pad}", got, again, want, "nonfinite" in extra)
    # the shallow-window kernel: one slot (full warps of one key), and a
    # half window of two slots
    for what, L, extra in (("one slot, one bin", 1, dict(one_bin=True)),
                           ("L=4 half", 4, {}),
                           ("L=4 half, NaN and inf", 4,
                            dict(nonfinite=True))):
        codes, heap, stats, base = _adversarial(torch, dev, 80 + L, n=n,
                                                c_pad=c_pad, b_val=b_val,
                                                L=L, **extra)
        kw = dict(base=base, L=L, n_bins=n_bins, half=L > 1)
        got, again = (HC.sbh_hist_radix(codes, heap, stats, **kw)
                      for _ in range(2))
        want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
        check_adversarial(torch, f"radix adversarial {what} n={n} "
                          f"C={c_pad}", got, again, want, "nonfinite" in extra)


def check_hist(torch, HC, what, got, codes, heap, stats, kw, int8):
    """Hold a histogram kernel's result against the plain version: equal
    for int32 sums, within HIST_RTOL of each stat row's scale against the
    plain version in f64 for f32 sums. Returns the max abs error."""
    want = HC.sbh_hist_plain(codes, heap, stats if int8 else stats.double(),
                             **kw)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}, "
          f"expected {tuple(want.shape)}")
    if int8:
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"{what}: int32 sums differ")
        say(f"kernel {what}: int32 sums equal")
        return 0.0
    err = hist_rel_err(got.double(), want)
    check(err <= HIST_RTOL, f"{what}: rel err {err}")
    say(f"kernel {what}: rel err {err:.3g} (tol {HIST_RTOL})")
    return (got.double() - want).abs().max().item()


def check_fused(torch, HC, what, h_k, got, args, kw, int8):
    """Hold the fused kernel against the sequential plain pair: heap ids
    identical, the histogram as check_hist holds it."""
    codes, heap, tbl, route_f, stats = args
    h_p, want = HC.sbh_route_hist_plain(
        codes, heap, tbl, route_f, stats if int8 else stats.double(), **kw)
    torch.cuda.synchronize()
    check(torch.equal(h_k, h_p), f"{what}: heap differs")
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    if int8:
        check(torch.equal(got, want), f"{what}: int32 sums differ")
        say(f"kernel {what}: heap identical, int32 sums equal")
        return 0.0
    err = hist_rel_err(got.double(), want)
    check(err <= HIST_RTOL, f"{what}: rel err {err}")
    say(f"kernel {what}: heap identical, rel err {err:.3g} (tol {HIST_RTOL})")
    return (got.double() - want).abs().max().item()


# ---------------------------------------------------------------------------
def _write_csv(path, n=4000, seed=3):
    rng = np.random.default_rng(seed)
    X = np.round(rng.normal(size=(n, 4)), 4)
    X[rng.random((n, 4)) < 0.05] = np.nan
    color = rng.choice(["red", "green", "blue", "teal"], n)
    logit = (1.4 * np.nan_to_num(X[:, 0]) - 0.9 * np.nan_to_num(X[:, 1])
             + np.where(color == "blue", 1.0, 0.0))
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    with open(path, "w") as f:
        f.write("a,b,c,d,color,label\n")
        for i in range(n):
            nums = ["NA" if np.isnan(v) else repr(float(v)) for v in X[i]]
            f.write(",".join(nums + [color[i], "yes" if y[i] else "no"])
                    + "\n")


def phase_small_path(torch, h2o, HC):
    """The CSV path on the card against the CPU, in the default
    configuration and with int8_hist=True. At depth 4 every level runs the
    shallow-window or the fused kernel."""
    for extra in ({}, {"int8_hist": True}):
        gbm = dict(ntrees=5, max_depth=4, learn_rate=0.2,
                   distribution="bernoulli", seed=5, **extra)
        with tempfile.TemporaryDirectory() as tmp:
            csv = os.path.join(tmp, "train.csv")
            _write_csv(csv)
            h2o.init(device="cpu")
            cfr = h2o.import_file(csv)
            cm = h2o.H2OGradientBoostingEstimator(**gbm)
            cm.train(y="label", training_frame=cfr)
            cpu_p = cm.predict(cfr).to_numpy()
            h2o.init()
            HC.reset_launches()
            fr = h2o.import_file(csv)
            m = h2o.H2OGradientBoostingEstimator(**gbm)
            m.train(y="label", training_frame=fr)
            pred = m.predict(fr)
            torch.cuda.synchronize()
            launches = dict(HC.LAUNCHES)
        check(fr.matrix().device.type == "cuda", "frame not on the card")
        p = pred.to_numpy()
        check(p.shape == (4000, 3) and np.isfinite(p).all(),
              "bad predictions")
        want = {"radix": 5, "fused": 15, "route_f": 5}
        got = {k: v for k, v in launches.items() if v}
        check(got == want, f"small path {extra} launches {launches}, "
              f"expected {want}")
        perr = float(np.abs(p[:, 1:] - cpu_p[:, 1:]).max())
        aerr = abs(m.auc() - cm.auc())
        say(f"small path {extra or 'default'}: 4000 rows csv -> gbm 5x4 -> "
            f"predict: AUC card {m.auc():.6f} cpu {cm.auc():.6f}; pred max "
            f"err {perr:.3g}; launches {got}")
        check(perr < 1e-3 and aerr < 1e-3,
              f"card and CPU disagree: pred {perr} auc {aerr}")
        check(m.auc() > 0.75, f"small path AUC {m.auc()}")


# ---------------------------------------------------------------------------
class Recorder:
    """Wraps a kernel wrapper to keep the inputs of its first `keep`
    calls (one tree's levels); the wrapper itself still runs and counts."""

    def __init__(self, fn, keep):
        self.fn, self.keep, self.calls = fn, keep, []

    def __call__(self, *args, **kw):
        if len(self.calls) < self.keep:
            self.calls.append((args, kw))
        return self.fn(*args, **kw)


def _higgs_frame(torch, h2o, dev, n, seed):
    """HIGGS-shaped frame made on the card: C N(0,1) features, the bench's
    logit, y ~ Bernoulli(sigmoid(logit))."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    C = HIGGS_C
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = torch.randn((n, C), generator=g, device=dev)
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
             + 0.4 * torch.sin(X[:, 4]) + 0.3 * X[:, 5] * X[:, 6])
    y = (torch.rand(n, generator=g, device=dev)
         < torch.sigmoid(logit)).float()
    names = [f"x{j}" for j in range(C)] + ["y"]
    vecs = [Vec.from_tensor(X[:, j].contiguous()) for j in range(C)]
    vecs.append(Vec.from_tensor(y, type=T_CAT, domain=["0", "1"]))
    return Frame(names, vecs)


# kernel wrappers recorded in the HIGGS runs (the dispatchers reach them
# through the module, so recording them catches every launch)
RECORDED = ("sbh_hist_dense", "sbh_route", "sbh_hist_radix",
            "sbh_route_hist_fused")


def train_run(torch, h2o, HC, fr, label, expect, keep, valid=None,
              estimator="H2OGradientBoostingEstimator", prior_trees=0,
              **params):
    """Train one model through the estimator with the launch counts reset
    just before and read just after; keep the first `keep[name]` calls of
    each recorded wrapper (one tree's). The launches per tree (over the
    trees this run built: a restart's prior trees are not counted) must
    equal `expect`. Returns (model, launches, train seconds, trees built,
    {name: calls})."""
    recs = {name: Recorder(getattr(HC, name), keep.get(name, 0))
            for name in RECORDED}
    saved = {name: getattr(HC, name) for name in RECORDED}
    for name, r in recs.items():
        setattr(HC, name, r)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        m = getattr(h2o, estimator)(**params)
        HC.reset_launches()
        t0 = time.perf_counter()
        m.train(y="y", training_frame=fr, validation_frame=valid)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(HC.LAUNCHES)
    finally:
        for name, fn in saved.items():
            setattr(HC, name, fn)
    trees = int(m.summary()["number_of_trees"]) - prior_trees
    per_tree = {k: v / trees for k, v in launches.items() if v}
    say(f"{label}: {fr.nrows} rows x {len(fr.names) - 1} features, {trees} "
        f"trees depth {params['max_depth']} nbins {params['nbins']}: train "
        f"{t_train:.3f} s ({fr.nrows * trees / t_train:.0f} row*trees/s), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({(torch.cuda.max_memory_allocated() - held) / 2**30:.2f} GiB "
        "above what was held before train())")
    say(f"{label} launches per tree: {per_tree} (expected {expect})")
    check(per_tree == expect, f"{label} launches per tree {per_tree}, "
          f"expected {expect}")
    for name, r in recs.items():
        check(len(r.calls) == keep.get(name, 0),
              f"{label}: {len(r.calls)} calls of {name} recorded")
    return m, launches, t_train, trees, {n: r.calls for n, r in recs.items()}


def higgs_run(torch, h2o, HC, fr, label, expect, keep, valid=None, **params):
    """A HIGGS run (train_run) whose train AUC must pass 0.7."""
    out = train_run(torch, h2o, HC, fr, f"higgs ({label})", expect, keep,
                    valid=valid, **params)
    m = out[0]
    say(f"higgs ({label}): train AUC {m.auc():.6f}")
    check(m.auc() > 0.7, f"higgs ({label}) train AUC {m.auc()}")
    return out


def phase_higgs(torch, h2o, HC):
    dev = h2o.init().device
    fr = _higgs_frame(torch, h2o, dev, HIGGS_N, 7)
    torch.cuda.synchronize()
    D = HIGGS_DEPTH
    out = {}

    # (a) the sequential route-then-histogram path, flags passed explicitly
    m, launches, _, _, calls = higgs_run(
        torch, h2o, HC, fr, "a: sequential", PER_TREE["sequential"],
        {"sbh_hist_dense": D, "sbh_route": D}, ntrees=HIGGS_TREES,
        max_depth=D, nbins=HIGGS_NBINS, distribution="bernoulli", seed=1,
        radix_shallow=False, fused_level=False)
    t0 = time.perf_counter()
    pred = m.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    p1 = pred.vec("p1").data
    check(pred.nrows == HIGGS_N and bool(torch.isfinite(p1).all()),
          "HIGGS predictions not finite")
    say(f"higgs (a) predict {HIGGS_N} rows: {t_pred:.3f} s")
    out["a"] = (launches, calls)
    del m, pred, p1

    # (b) the default configuration, validation frame, early stopping
    valid = _higgs_frame(torch, h2o, dev, HIGGS_VALID_N, 8)
    keep = {"sbh_hist_radix": 1, "sbh_route_hist_fused": 5,
            "sbh_hist_dense": 2, "sbh_route": 3}
    aucs = {}
    for label, extra, expect in (("b: default", {}, PER_TREE["default"]),
                                 ("c: int8_hist", {"int8_hist": True},
                                  PER_TREE["int8"])):
        m, launches, t_train, trees, calls = higgs_run(
            torch, h2o, HC, fr, label, expect, keep, valid=valid,
            **HIGGS_DEFAULT, **extra)
        hist = m.scoring_history()
        vauc, last = m.auc(valid=True), hist[-1]
        stopped = trees < HIGGS_DEFAULT["ntrees"]
        say(f"higgs ({label}): train AUC {m.auc():.6f}, validation AUC "
            f"{vauc:.6f} (last history entry {last['validation_auc']:.6f}, "
            f"validation logloss {last['validation_logloss']:.6f}); "
            f"{trees} trees built, stopped early: {stopped}")
        check(vauc > 0.7, f"higgs ({label}) validation AUC {vauc}")
        check(abs(last["validation_auc"] - vauc) < 1e-4,
              f"higgs ({label}): history validation AUC "
              f"{last['validation_auc']} vs final {vauc}")
        aucs[label[0]] = m.auc()
        out[label[0]] = (launches, calls)
        del m
    say(f"higgs train AUC: default {aucs['b']:.6f}, int8_hist "
        f"{aucs['c']:.6f}")
    out["f"] = drf_run(torch, h2o, HC, fr, valid)
    # (g) and (h): the adaptive engine at HIGGS width
    xgboost_run(torch, h2o, HC, fr, valid)
    del valid
    adaptive_stage_table(torch, h2o, fr, "run (g)", "H2OXGBoostEstimator",
                         **XGB_HIGGS)
    time_range_forms(torch, fr)
    deep_drf_run(torch, h2o, HC, fr)
    adaptive_stage_table(torch, h2o, fr, "run (h)",
                         "H2ORandomForestEstimator", **DRF_DEEP)
    breakdown(torch, h2o, HC, fr, "higgs (default configuration)",
              ntrees=HIGGS_TREES, max_depth=HIGGS_DEPTH, nbins=HIGGS_NBINS,
              distribution="bernoulli", seed=1)
    busy_share(torch, h2o, fr)
    return out


def drf_run(torch, h2o, HC, fr, valid):
    """Run (f): a binomial forest to depth 10 on the HIGGS frame with the
    validation frame; OOB and validation AUC, the validation series, and
    the predict time of every training row. Keeps one tree's dense
    histogram and route calls (levels 6-9 and the terminal route)."""
    m, launches, _, trees, calls = train_run(
        torch, h2o, HC, fr, "drf (f): binomial forest", PER_TREE["drf10"],
        {"sbh_hist_dense": 4, "sbh_route": 5}, valid=valid,
        estimator="H2ORandomForestEstimator", **DRF_HIGGS)
    summary, last = m.summary(), m.scoring_history()[-1]
    oob, vauc = m.auc(), m.auc(valid=True)
    t0 = time.perf_counter()
    pred = m.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    p1 = pred.vec("p1").data
    say(f"drf (f): {trees} trees, mtries {summary['mtries']}, OOB (training) "
        f"AUC {oob:.6f}, validation AUC {vauc:.6f} (last history entry "
        f"{last['validation_auc']:.6f}), oob_scored {summary['oob_scored']};"
        f" predict {fr.nrows} rows: {t_pred:.3f} s")
    check(summary["oob_scored"] is True, "drf (f): not OOB-scored")
    check(trees == DRF_HIGGS["ntrees"], f"drf (f): {trees} trees")
    check(oob > 0.7 and vauc > 0.7, f"drf (f) AUC: OOB {oob}, valid {vauc}")
    check(abs(last["validation_auc"] - vauc) < 1e-4,
          f"drf (f): history validation AUC {last['validation_auc']} vs "
          f"final {vauc}")
    check(pred.nrows == fr.nrows and bool(torch.isfinite(p1).all())
          and bool(((p1 >= 0) & (p1 <= 1)).all()),
          "drf (f): predictions not probabilities")
    return launches, calls


def _covtype_frame(torch, dev, n, seed):
    """Covertype-shaped frame made on the card from a seeded
    torch.Generator: 10 N(0,1) columns for the numeric fields, 4 one-hot
    0/1 wilderness and 40 one-hot 0/1 soil columns, and 7 classes, the
    argmax over classes of log(Covertype's class share) + a fixed score of
    a few columns + Gumbel noise. Returns (frame, class ids)."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    K = len(COV_PRIOR)
    Xn = torch.randn((n, COV_NUM), generator=g, device=dev)
    wild = torch.randint(0, COV_WILD, (n,), generator=g, device=dev)
    soil = torch.randint(0, COV_SOIL, (n,), generator=g, device=dev)
    onehot = torch.nn.functional.one_hot
    B = torch.cat([onehot(wild, COV_WILD), onehot(soil, COV_SOIL)], 1)
    k = torch.arange(K, device=dev)
    score = (torch.log(torch.tensor(COV_PRIOR, device=dev))[None, :]
             + 1.2 * Xn[:, :K] - 0.6 * Xn[:, 7:10].repeat(1, 3)[:, :K]
             + 0.8 * (wild[:, None] == (k % COV_WILD)[None, :])
             + 1.0 * ((soil[:, None] % K) == k[None, :]))
    u = torch.rand((n, K), generator=g, device=dev).clamp(1e-12, 1 - 1e-7)
    y = torch.argmax(score - torch.log(-torch.log(u)), dim=1)
    X = torch.cat([Xn, B.float()], 1)
    names = ([f"n{j}" for j in range(COV_NUM)]
             + [f"wild{j}" for j in range(COV_WILD)]
             + [f"soil{j}" for j in range(COV_SOIL)] + ["y"])
    vecs = [Vec.from_tensor(X[:, j].contiguous()) for j in range(X.shape[1])]
    vecs.append(Vec.from_tensor(y.float(), type=T_CAT,
                                domain=[str(c + 1) for c in range(K)]))
    return Frame(names, vecs), y


def _same_splits(torch, a, b, t):
    """Tree t of two ensembles splits alike node for node (columns,
    thresholds, NA directions)."""
    return all(torch.equal(getattr(a, f)[t], getattr(b, f)[t])
               for f in ("col", "thr", "na_left"))


class RestartProbe:
    """Hooks on the multinomial chunk trainer and the split search for one
    training run: the margins that the `at`-th chunk (counting from 0)
    starts from, and the histogram, lam and choice of each of the
    `searches` split searches that follow (the K class trees' levels of
    that chunk's first iteration). The copies cost a few milliseconds of
    the run's train()."""

    def __init__(self, BN, at, searches):
        self.BN, self.at, self.searches = BN, at, searches
        self.trainer, self.find = BN.gbm_multi_chunk_trainer, \
            BN.find_splits_binned
        self.chunks, self.left, self.F, self.splits = 0, 0, None, []

    def __enter__(self):
        probe = self

        def trainer(*a, **k):
            run = probe.trainer(*a, **k)

            def call(codes, y1, w1, F, generator=None):
                if probe.chunks == probe.at:
                    probe.F, probe.left = F.clone(), probe.searches
                probe.chunks += 1
                return run(codes, y1, w1, F, generator)
            return call

        def find(hist, *a, **k):
            s = probe.find(hist, *a, **k)
            if probe.left:
                probe.left -= 1
                probe.splits.append((hist.clone(), k, {
                    f: s[f].clone() for f in ("did", "col", "bin", "nal",
                                              "gain")}))
            return s
        self.BN.gbm_multi_chunk_trainer = trainer
        self.BN.find_splits_binned = find
        return self

    def __exit__(self, *exc):
        self.BN.gbm_multi_chunk_trainer = self.trainer
        self.BN.find_splits_binned = self.find


def _split_gain(torch, h, col, b, nal, k):
    """The split search's gain of one numeric split (column, last bin on
    the left, NA direction) of one leaf's histogram h (C_pad, 4, BP), in
    float64."""
    B, lam = k["b_val"], k["lam"]
    rows = h[col].double()
    den = rows[2] if k["use_hess"] else rows[0]
    g = rows[1]
    gl = g[:b + 1].sum() + (g[B] if nal else 0.0)
    dl = den[:b + 1].sum() + (den[B] if nal else 0.0)
    gt, dt = g[:B + 1].sum(), den[:B + 1].sum()

    def score(d_, g_):
        return float(g_ * g_ / max(float(d_) + lam, 1e-30)) if d_ > 0 \
            else 0.0
    return score(dl, gl) + score(dt - dl, gt - gl) - score(dt, gt)


def restart_probe_report(torch, n, depth, dp, ep):
    """The restart's margins against the ones (d) had routed at the same
    iteration, and the first split of the restart's first iteration that
    differs from (d)'s: both choices' gains on both runs' histograms."""
    dF = (ep.F[:n] - dp.F[:n]).abs().max().item()
    say(f"covtype (e): margins the restart walked from the prior's trees "
        f"vs (d)'s routed margins after the same iterations: max abs diff "
        f"{dF:.3g} over {n} rows x {dp.F.shape[1]} classes (max |F| "
        f"{dp.F[:n].abs().max().item():.3g})")
    check(dF < 1e-4, f"covtype (e): the restart resumed from other margins "
          f"(max abs diff {dF})")
    for i, ((hd, k, sd), (he, _, se)) in enumerate(zip(dp.splits,
                                                       ep.splits)):
        diff = (sd["did"] != se["did"]) | (sd["did"] & (
            (sd["col"] != se["col"]) | (sd["bin"] != se["bin"])
            | (sd["nal"] != se["nal"])))
        if not bool(diff.any()):
            continue
        c, lev = divmod(i, depth)
        leaf = int(diff.nonzero()[0, 0])
        pick = [(int(s["col"][leaf]), int(s["bin"][leaf]),
                 bool(s["nal"][leaf])) for s in (sd, se)]
        gains = [[_split_gain(torch, h[leaf], *sp, k) for sp in pick]
                 for h in (hd, he)]
        rel = [abs(g[0] - g[1]) / max(abs(g[0]), 1e-300) for g in gains]
        hrel = ((hd[leaf] - he[leaf]).abs().amax(dim=(0, 2))
                / hd[leaf].abs().amax(dim=(0, 2)).clamp(min=1e-30))
        say(f"covtype (e): first split of the restart's first iteration "
            f"that differs from (d)'s: class {c} level {lev} leaf {leaf} "
            f"({float(hd[leaf, 0, 0].sum()):.0f} rows); (d) chose column/"
            f"bin/NA-left {pick[0]} with gain {float(sd['gain'][leaf]):.9g}"
            f", the restart {pick[1]} with gain {float(se['gain'][leaf]):.9g}"
            f"; in float64 on (d)'s histogram {gains[0][0]:.9g} vs "
            f"{gains[0][1]:.9g} (relative gap {rel[0]:.3g}), on the "
            f"restart's {gains[1][0]:.9g} vs {gains[1][1]:.9g} (relative "
            f"gap {rel[1]:.3g}); the leaf's histograms differ by at most "
            f"{hrel[0].item():.3g} / {hrel[1].item():.3g} / "
            f"{hrel[2].item():.3g} of their largest w / wg / wh bin")
        return
    say("covtype (e): every split of the restart's first iteration is "
        "(d)'s")


def phase_covtype(torch, h2o, HC):
    """Runs (d) and (e): a multinomial GBM at Covertype width, then the
    same model built as 10 iterations and a checkpoint restart to 20.
    Returns (d)'s launches and one tree's recorded calls."""
    from h2o3_tpu_torch.models.tree import binned as BN
    dev = h2o.init().device
    fr, y = _covtype_frame(torch, dev, COV_N, 9)
    valid, _ = _covtype_frame(torch, dev, COV_VALID_N, 10)
    K = len(COV_PRIOR)
    prior = torch.bincount(y, minlength=K).double() / COV_N
    entropy = float(-(prior * prior.clamp(min=1e-300).log()).sum())
    del y
    torch.cuda.synchronize()
    keep = {"sbh_hist_radix": 1, "sbh_route_hist_fused": 5,
            "sbh_hist_dense": 2, "sbh_route": 3}
    half = COV_GBM["ntrees"] // 2
    interval = COV_GBM["score_tree_interval"]
    searches = K * COV_GBM["max_depth"]
    # (d)'s margins after `half` iterations, where (e)'s restart starts
    with RestartProbe(BN, half // interval, searches) as dp:
        d, launches, _, trees, calls = train_run(
            torch, h2o, HC, fr, "covtype (d): multinomial GBM",
            PER_TREE["multinomial"], keep, valid=valid, **COV_GBM)
    check(trees == COV_GBM["ntrees"] * K, f"covtype (d): {trees} trees")
    ll, vll = d.logloss(), d.logloss(valid=True)
    last = d.scoring_history()[-1]
    t0 = time.perf_counter()
    pv = d.predict(valid)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    P = torch.stack([pv.vec(f"p{c + 1}").data for c in range(K)], 1)
    psum_err = (P.double().sum(1) - 1).abs().max().item()
    say(f"covtype (d): {trees} trees ({COV_GBM['ntrees']} iterations x "
        f"{K} classes); training logloss {ll:.6f} (last history entry "
        f"{last['training_logloss']:.6f}, class prior entropy "
        f"{entropy:.6f}), error {d._output.training_metrics.error:.6f}; "
        f"validation logloss {vll:.6f}; predict {COV_VALID_N} rows "
        f"{t_pred:.3f} s, probabilities sum to 1 within {psum_err:.3g}")
    check(bool(torch.isfinite(P).all()) and psum_err < 1e-5,
          f"covtype (d): probabilities bad (sum err {psum_err})")
    check(ll < entropy - COV_LOGLOSS_MARGIN, f"covtype (d): training logloss "
          f"{ll} not below the prior's entropy {entropy} by "
          f"{COV_LOGLOSS_MARGIN}")
    check(abs(last["training_logloss"] - ll) < 1e-4, f"covtype (d): history "
          f"logloss {last['training_logloss']} vs final {ll}")
    check(math.isfinite(vll), f"covtype (d): validation logloss {vll}")
    del pv, P

    # (e) the same model as 10 iterations, then a restart to 20
    e1, *_ = train_run(
        torch, h2o, HC, fr, "covtype (e): first 10 iterations",
        PER_TREE["multinomial"], {}, valid=valid,
        **dict(COV_GBM, ntrees=half, model_id="covtype_e1"))
    with RestartProbe(BN, 0, searches) as ep:
        e2, *_ = train_run(
            torch, h2o, HC, fr, "covtype (e): restart to 20 iterations",
            PER_TREE["multinomial"], {}, valid=valid, prior_trees=half * K,
            **dict(COV_GBM, checkpoint="covtype_e1"))
    restart_probe_report(torch, COV_N, COV_GBM["max_depth"], dp, ep)
    del dp, ep
    same = [sum(_same_splits(torch, a, b, t)
                for a, b in zip(d._trees_k, e2._trees_k))
            for t in range(COV_GBM["ntrees"])]
    dval = [max((a.value[t] - b.value[t]).abs().max().item()
                for a, b in zip(d._trees_k, e2._trees_k))
            for t in range(COV_GBM["ntrees"])]
    dll, dvll = abs(e2.logloss() - ll), abs(e2.logloss(valid=True) - vll)
    say(f"covtype (e): restart training logloss {e2.logloss():.6f} (d: "
        f"{ll:.6f}, diff {dll:.3g}), validation logloss "
        f"{e2.logloss(valid=True):.6f} (d: {vll:.6f}, diff {dvll:.3g}); "
        f"trees that split as (d)'s node for node: prior {sum(same[:half])} "
        f"of {half * K} (leaf values max diff {max(dval[:half]):.3g}), "
        f"restart {sum(same[half:])} of {half * K} (leaf values max diff "
        f"{max(dval[half:]):.3g})")
    # the prior is (d)'s first iterations built again: the same bits
    check(all(c == K for c in same[:half]) and max(dval[:half]) == 0.0,
          f"covtype (e): the prior's trees differ from (d)'s first {half} "
          f"iterations: {same[:half]}, values {max(dval[:half])}")
    check(dll < 1e-3 and dvll < 1e-3, f"covtype (e): restart logloss off by "
          f"{dll} (training), {dvll} (validation)")
    try:
        h2o.H2OGradientBoostingEstimator(
            **dict(COV_GBM, ntrees=half, checkpoint="covtype_e1")).train(
            y="y", training_frame=fr)
        fail("covtype (e): a restart with ntrees not above the prior's ran")
    except ValueError as e:
        say(f"covtype (e): a restart to {half} iterations raises ValueError: "
            f"{e}")
    breakdown(torch, h2o, HC, fr, "covtype (d) configuration",
              **dict(COV_GBM, ntrees=2))
    del d, e1, e2, valid
    covtype_drf_run(torch, h2o, HC, fr, entropy)
    return launches, calls


class Stopwatch:
    """Times every call of a function, synchronising the card before and
    after so that each span holds its own device work."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.seconds, self.calls = torch, fn, 0.0, 0

    def __call__(self, *args, **kw):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kw)
        self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return out


def breakdown(torch, h2o, HC, fr, label, **params):
    """A GBM training run (no validation frame) with a stopwatch on each
    stage of the estimator and on each kernel wrapper (the syncs make it a
    little slower than an unperturbed run)."""
    from h2o3_tpu_torch.models import model as MB
    from h2o3_tpu_torch.models.tree import binned as BN
    from h2o3_tpu_torch.models.tree import shared_tree as ST
    stages = [(MB.ModelBase, "_resolve_predictors"),
              (ST.SharedTreeEstimator, "_binned_setup"),
              (BN.BinnedGrower, "grow"), (BN, "find_splits_binned"),
              (ST.SharedTreeEstimator, "_record_history"),
              (ST.SharedTreeEstimator, "_record_history_multi"),
              (MB.ModelBase, "_score_train_valid")]
    stages += [(HC, name) for name in RECORDED]
    saved = [(obj, name, getattr(obj, name)) for obj, name in stages]
    watches = {}
    try:
        for obj, name, fn in saved:
            watches[name] = Stopwatch(torch, fn)
            if isinstance(obj, type):
                w = watches[name]
                setattr(obj, name, lambda *a, _w=w, **k: _w(*a, **k))
            else:
                setattr(obj, name, watches[name])
        m = h2o.H2OGradientBoostingEstimator(**params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    parts = ", ".join(f"{n} {w.seconds:.3f} s/{w.calls}"
                      for n, w in watches.items())
    say(f"{label} train breakdown, {m.summary()['number_of_trees']} trees: "
        f"total {total:.3f} s; {parts} (find_splits_binned and the kernel "
        "wrappers run inside grow)")


def busy_share(torch, h2o, fr):
    """Run (c)'s configuration for 10 trees (no validation frame) under
    torch.profiler, and print the share of the train() window in which the
    card ran a kernel, a copy or a fill (the union of their intervals in
    the trace), with the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile, record_function
    m = h2o.H2OGradientBoostingEstimator(
        ntrees=HIGGS_TREES, max_depth=HIGGS_DEPTH, nbins=HIGGS_NBINS,
        distribution="bernoulli", seed=1, int8_hist=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("h2o3_train"):
            m.train(y="y", training_frame=fr)
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("name") == "h2o3_train"
              and e.get("cat") == "user_annotation" and "dur" in e]
    check(len(window) == 1, f"profiler: {len(window)} train() windows")
    t0, t1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    dev = sorted((max(e["ts"], t0), min(e["ts"] + e["dur"], t1), e)
                 for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                 and "dur" in e)
    if not dev:
        say("profiler: busy share not measured (the trace holds no device "
            "activity)")
        return
    busy, end = 0.0, t0
    for a, b, _ in dev:
        if b > max(a, end):
            busy += b - max(a, end)
        end = max(end, b)
    by_name = {}
    for a, b, e in dev:
        if e.get("cat") == "kernel":
            key = re.sub(r"^void |\(anonymous namespace\)::", "", e["name"])
            key = re.sub(r"[<(].*", "", key)
            by_name[key] = by_name.get(key, 0.0) + max(0.0, b - a)
    ours = sum(v for k, v in by_name.items() if re.search(
        r"(route|hist|radix|fused|pack)\w*_kernel$", k)
        and "::" not in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    say(f"profiler, run (c) configuration, {HIGGS_TREES} trees: the card is "
        f"busy {busy / 1e3:.3f} ms of the {(t1 - t0) / 1e3:.3f} ms train() "
        f"window: busy share {busy / (t1 - t0):.4f}; the port's kernels "
        f"{ours / 1e3:.3f} ms; {len(dev)} device events; most device time: "
        + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in top))


# ---------------------------------------------------------------------------
# Runs (g)-(j): the adaptive engine (models/tree/engine.py TreeGrower). It
# is plain PyTorch: no wrapper of ops/hist_cuda.py may count a launch.
def _sub_frame(fr, n):
    """The first n rows of a frame, as a frame on the same device."""
    from h2o3_tpu_torch.core.frame import Frame, Vec
    return Frame(fr.names, [Vec.from_tensor(v.data[:n].contiguous(),
                                            type=v.type, domain=v.domain)
                            for v in fr.vecs])


def _deepest_level(trees):
    """The depth of the deepest leaf: one below the deepest split node."""
    split = (trees.col >= 0).nonzero()
    if split.numel() == 0:
        return 0
    return int(math.log2(int(split[:, 1].max()) + 1)) + 1


def _stage_bytes(fn, args, out):
    """The bytes one call of an adaptive stage must move: every input read
    once and every output written once, as the port holds them."""
    def nb(t):
        return t.numel() * t.element_size() if hasattr(t, "numel") else 0
    outs = out if isinstance(out, tuple) else (out,)
    if fn == "route_rows":
        # one f32 of the split column per row, the row state in and out,
        # the per-leaf tables
        X, leaf, heap, active = args[:4]
        return (4 * leaf.numel() + 2 * (nb(leaf) + nb(heap) + nb(active))
                + sum(nb(t) for t in args[4:8]))
    if fn == "in_sample_rows":
        args = args[:3]
    return sum(nb(a) for a in args) + sum(nb(o) for o in outs)


class StageWatch(Stopwatch):
    """A Stopwatch on one stage function of the adaptive engine that also
    adds up the bytes its calls must move (the stage table's bound)."""

    def __init__(self, torch, fn, name):
        super().__init__(torch, fn)
        self.name, self.nbytes = name, 0

    def __call__(self, *args, **kw):
        out = super().__call__(*args, **kw)
        self.nbytes += _stage_bytes(self.name, args, out)
        return out


def adaptive_stage_table(torch, h2o, fr, label, estimator, **params):
    """One tree of a run with a StageWatch on each stage function of the
    adaptive engine (module globals, so the level step reaches them);
    prints each stage's time beside its bound (bytes over 3.35 TB/s)."""
    from h2o3_tpu_torch.models.tree import engine as E
    m = getattr(h2o, estimator)(**dict(params, ntrees=1))
    watches = {key: StageWatch(torch, getattr(E, fn), fn)
               for key, fn in STAGES}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        for key, fn in STAGES:
            setattr(E, fn, watches[key])
        m.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
    finally:
        for key, fn in STAGES:
            setattr(E, fn, watches[key].fn)
    total = time.perf_counter() - t0
    say(f"adaptive stages, one tree of {label}: train {total:.3f} s; "
        + ", ".join(f"{k} {1e3 * w.seconds:.3f} ms/{w.calls} (bound "
                    f"{1e3 * w.nbytes / HBM_BYTES_S:.4f})"
                    for k, w in watches.items()))


def time_range_forms(torch, fr):
    """The two forms of the adaptive engine's per-(leaf, column) ranges at
    run (g)'s rows (11M x 28 of the HIGGS frame), over seeded random
    leaves: rows sorted by leaf and reduced a leaf at a time, against a
    scatter min/max (engine.SORTED_RANGE_LEAVES picks
    between them by the level's leaves). Both give the same bits."""
    from h2o3_tpu_torch.models.tree import engine as E
    X = torch.stack([v.data for v in fr.vecs[:HIGGS_C]], 1)
    g = torch.Generator(device=X.device)
    g.manual_seed(3)
    saved, parts = E.SORTED_RANGE_LEAVES, []
    try:
        for L in (2, 32, 128, 512, 4096):
            ls = torch.randint(0, L, (X.shape[0],), generator=g,
                               device=X.device)
            res = {}
            for form, limit in (("sorted", 1 << 30), ("scatter", 0)):
                E.SORTED_RANGE_LEAVES = limit
                res[form] = (time_ms(torch, lambda: E._ranges(X, ls, L), 3),
                             E._ranges(X, ls, L))
            same = all(torch.equal(a, b) for a, b in
                       zip(res["sorted"][1], res["scatter"][1]))
            check(same, f"range forms differ at L {L}")
            parts.append(f"L {L}: sorted {res['sorted'][0]:.3f} ms, "
                         f"scatter {res['scatter'][0]:.3f} ms")
    finally:
        E.SORTED_RANGE_LEAVES = saved
    say(f"adaptive ranges, {X.shape[0]} rows x {X.shape[1]} columns, the "
        f"two forms (bit-identical): " + "; ".join(parts))


def adaptive_run(torch, h2o, HC, fr, label, valid=None, **params):
    """An adaptive-engine run through train_run: no kernel launch, the
    deepest level reached and the seconds a tree."""
    m, launches, t_train, trees, _ = train_run(
        torch, h2o, HC, fr, label, {}, {}, valid=valid, **params)
    check(not any(launches.values()), f"{label}: kernel launches "
          f"{launches} on the adaptive engine")
    ens = m._trees_k if getattr(m, "_trees_k", None) is not None \
        else [m._trees]
    deepest = max(_deepest_level(t) for t in ens)
    grown = sum(t.ntrees for t in ens)
    say(f"{label}: {grown} trees grown, {t_train / max(grown, 1):.3f} s a "
        f"tree, deepest level reached {deepest} of {params['max_depth']}")
    return m, t_train, trees, deepest


def xgboost_run(torch, h2o, HC, fr, valid):
    """Run (g): XGBoost at its defaults, 20 trees, on the HIGGS frame with
    its validation frame; then TreeSHAP over 10,000 of its rows."""
    m, *_ = adaptive_run(torch, h2o, HC, fr, "xgboost (g): HIGGS",
                         valid=valid, estimator="H2OXGBoostEstimator",
                         **XGB_HIGGS)
    auc, vauc = m.auc(), m.auc(valid=True)
    last = m.scoring_history()[-1]
    say(f"xgboost (g): train AUC {auc:.6f}, validation AUC {vauc:.6f} (last "
        f"history entry {last['validation_auc']:.6f})")
    check(auc > 0.7 and vauc > 0.7, f"xgboost (g) AUC {auc}, valid {vauc}")
    check(abs(last["validation_auc"] - vauc) < 1e-4, f"xgboost (g): history "
          f"validation AUC {last['validation_auc']} vs final {vauc}")
    # the histogram sums in exact fixed point: a second training builds the
    # same trees bit for bit (an f32 scatter-add's order would not)
    again = h2o.H2OXGBoostEstimator(**XGB_HIGGS)
    again.train(y="y", training_frame=fr)
    same = all(torch.equal(getattr(m._trees, k), getattr(again._trees, k))
               for k in ("col", "thr", "na_left", "value"))
    say(f"xgboost (g): trained again, the same trees bit for bit: {same} "
        f"(train AUC {again.auc():.6f})")
    check(same, "xgboost (g): a second training built other trees")
    del again
    sub = _sub_frame(fr, XGB_SHAP_ROWS)
    from h2o3_tpu_torch.models.tree import engine as E
    X = m._dinfo.matrix(sub)
    margin = (m._f0 + float(m.params["learn_rate"])
              * E.predict_ensemble(X, m._trees)).double().cpu().numpy()
    t0 = time.perf_counter()
    phi = m.predict_contributions(sub).to_numpy()
    t_shap = time.perf_counter() - t0
    err = float(np.abs(phi.sum(1) - margin).max())
    say(f"xgboost (g): TreeSHAP of {XGB_SHAP_ROWS} rows x {X.shape[1]} "
        f"features over {m._trees.ntrees} trees in {t_shap:.3f} s (host "
        f"C++); rows sum to the margin within {err:.3g}")
    check(phi.shape == (XGB_SHAP_ROWS, X.shape[1] + 1) and err < 1e-4,
          f"xgboost (g): SHAP rows off the margin by {err}")
    del m


def deep_drf_run(torch, h2o, HC, fr):
    """Run (h): DRF at H2O's defaults (depth 20) on the HIGGS frame."""
    m, t_train, trees, deepest = adaptive_run(
        torch, h2o, HC, fr, "drf (h): HIGGS at H2O's defaults",
        estimator="H2ORandomForestEstimator", **DRF_DEEP)
    oob = m.auc()
    say(f"drf (h): OOB AUC {oob:.6f}, mtries {m.summary()['mtries']}, "
        f"engine {m.summary()['engine']}")
    check(oob > 0.7, f"drf (h) OOB AUC {oob}")
    check(trees == DRF_DEEP["ntrees"], f"drf (h): {trees} trees")
    del m


def covtype_drf_run(torch, h2o, HC, fr, entropy):
    """Run (i): a multinomial DRF at DRF's defaults (depth 20) on the
    Covertype frame, 3 iterations of 7 class trees."""
    K = len(COV_PRIOR)
    m, t_train, trees, deepest = adaptive_run(
        torch, h2o, HC, fr, "covtype (i): multinomial DRF",
        estimator="H2ORandomForestEstimator", **COV_DRF)
    ll = m.logloss()
    say(f"covtype (i): training logloss {ll:.6f} (class prior entropy "
        f"{entropy:.6f}), {m.summary()['number_of_trees']} iterations of "
        f"{K} class trees")
    check(trees == COV_DRF["ntrees"],
          f"covtype (i): {trees} iterations built")
    check(ll < entropy - COV_LOGLOSS_MARGIN, f"covtype (i): training "
          f"logloss {ll} not below the prior's entropy {entropy} by "
          f"{COV_LOGLOSS_MARGIN}")
    del m


def _cc_frame(torch, dev, seed=11):
    """The credit-card-width frame: CC_N rows x CC_C N(0,1) columns made
    from a seeded torch.Generator on `dev`, CC_ANOM anomalies at seeded
    rows shifted by ISO_SHIFT in ISO_SHIFT_COLS seeded columns, and their
    0/1 labels as column "y" (which the isolation forest leaves out as
    the response)."""
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    X = torch.randn((CC_N, CC_C), generator=g, device=dev)
    rows = torch.randperm(CC_N, generator=g, device=dev)[:CC_ANOM]
    cols = torch.randperm(CC_C, generator=g, device=dev)[:ISO_SHIFT_COLS]
    X[rows[:, None], cols[None, :]] += ISO_SHIFT
    y = torch.zeros(CC_N, device=dev)
    y[rows] = 1.0
    names = [f"v{j}" for j in range(CC_C)] + ["y"]
    vecs = [Vec.from_tensor(X[:, j].contiguous()) for j in range(CC_C)]
    vecs.append(Vec.from_tensor(y, type=T_CAT, domain=["0", "1"]))
    return Frame(names, vecs), y


def iso_auc(torch, m, fr, y):
    from h2o3_tpu_torch.models import metrics as M
    score = torch.as_tensor(m.predict(fr).to_numpy()[:, 0],
                            dtype=torch.float32)
    return M.binomial_metrics(y.cpu(), score).auc


def phase_isofor(torch, h2o, HC):
    """Run (j): an isolation forest at H2O's defaults at the width of the
    credit-card fraud set; the AUC of its score against the planted
    labels."""
    dev = h2o.init().device
    fr, y = _cc_frame(torch, dev)
    m, t_train, trees, deepest = adaptive_run(
        torch, h2o, HC, fr, "isolation forest (j): credit-card width",
        estimator="H2OIsolationForestEstimator", **ISO)
    t0 = time.perf_counter()
    auc = iso_auc(torch, m, fr, y)
    t_pred = time.perf_counter() - t0
    say(f"isolation forest (j): {CC_N} rows x {CC_C} columns, {CC_ANOM} "
        f"planted anomalies: score AUC {auc:.6f} (bar {ISO_AUC_BAR}; a CPU "
        f"run of the same generator: {ISO_AUC_CPU}); sample size "
        f"{m._psi}; predict {t_pred:.3f} s")
    check(auc > ISO_AUC_BAR, f"isolation forest (j) AUC {auc}")


def phase_small_adaptive(torch, h2o, HC):
    """The CSV of phase 3 on the card against the CPU: XGBoost and a
    UniformAdaptive GBM (AUC within 1e-3), and an isolation forest with
    the same draws (the CPU generator's, moved to the card) whose score
    AUC against the label must agree within 1e-3. No kernel launches."""
    from h2o3_tpu_torch.models.tree import engine as E
    from h2o3_tpu_torch.models.tree import shared_tree as ST
    runs = (("xgboost", "H2OXGBoostEstimator",
             dict(ntrees=5, max_depth=4, seed=5)),
            ("gbm UniformAdaptive", "H2OGradientBoostingEstimator",
             dict(ntrees=5, max_depth=5, seed=5,
                  histogram_type="UniformAdaptive")),
            ("isolation forest", "H2OIsolationForestEstimator",
             dict(ntrees=20, max_depth=6, sample_size=128, seed=5)))
    saved = ST.SharedTreeEstimator._draws
    try:
        with tempfile.TemporaryDirectory() as tmp:
            csv = os.path.join(tmp, "train.csv")
            _write_csv(csv)
            for label, est, params in runs:
                res = {}
                for where in ("cpu", "cuda"):
                    h2o.init(device="cpu") if where == "cpu" else h2o.init()
                    ST.SharedTreeEstimator._draws = (
                        lambda self, device: E.Draws(
                            torch.Generator().manual_seed(5), device))
                    fr = h2o.import_file(csv)
                    HC.reset_launches()
                    m = getattr(h2o, est)(**params)
                    m.train(y="label", training_frame=fr)
                    launches = {k: v for k, v in HC.LAUNCHES.items() if v}
                    y = fr.vec("label").data.cpu()
                    res[where] = (iso_auc(torch, m, fr, y)
                                  if est == "H2OIsolationForestEstimator"
                                  else m.auc(), launches,
                                  fr.matrix().device.type)
                (ca, _, _), (ga, gl, gd) = res["cpu"], res["cuda"]
                say(f"small path adaptive {label}: AUC card {ga:.6f} cpu "
                    f"{ca:.6f} (diff {abs(ga - ca):.3g}); launches {gl}")
                check(gd == "cuda" and not gl, f"small path {label}: "
                      f"device {gd}, launches {gl}")
                check(abs(ga - ca) < 1e-3, f"small path {label}: card AUC "
                      f"{ga} vs cpu {ca}")
    finally:
        ST.SharedTreeEstimator._draws = saved


# ---------------------------------------------------------------------------
def time_ms(torch, fn, reps):
    fn()                                  # warm up
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _bound_ms(nbytes, ops):
    tb, to = nbytes / HBM_BYTES_S * 1e3, ops / F32_OPS_S * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def _hist_index_add(torch, HC, codes, heap, stats, base, L, n_bins, half):
    """One library call computing the same histogram: index_add_ over the
    flattened (slot, column, bin) index of every (row, column), in the
    stats' dtype. Returns the call; building its index is set-up, not
    timed."""
    _, _, _, L_pad = HC.hist_layout(L, half)
    c_pad, n = codes.shape
    leaf = heap.long() - base
    ok = (leaf >= 0) & (leaf < L)
    if half:
        ok &= (leaf & 1) == 0
        leaf = leaf >> 1
    slot = torch.where(ok, leaf, L_pad)
    cols = torch.arange(c_pad, device=codes.device)[:, None]
    idx = ((slot[None, :] * c_pad + cols) * n_bins + codes.long()).reshape(-1)
    src = stats[:3].t().repeat(c_pad, 1)
    out = torch.zeros(((L_pad + 1) * c_pad * n_bins, 3), dtype=stats.dtype,
                      device=codes.device)
    return lambda: out.index_add_(0, idx, src)


def _rows_in(heap, base, L, half):
    """Rows a histogram of leaves [base, base+L) sums (even leaves only
    with half)."""
    leaf = heap.long() - base
    inw = (leaf >= 0) & (leaf < L)
    if half:
        inw &= (leaf & 1) == 0
    return int(inw.sum().item())


def _rows_routed(heap, tbl, base, L):
    """Rows of leaves [base, base+L) that split: each reads one code byte
    of its split column."""
    leaf = heap.long() - base
    active = (leaf >= 0) & (leaf < L)
    did = tbl[1, leaf.clamp(0, L - 1)] > 0.5
    return int((active & did).sum().item())


def time_hist(torch, HC, name, args, kw):
    """Time one recorded histogram launch (dense or shallow-window) beside
    its plain version, index_add_ and its bound; hold it to the plain
    version first."""
    codes, heap, stats = args
    fn = getattr(HC, name)
    int8 = bool(kw.get("int8", False))
    pkw = {k: v for k, v in kw.items() if k not in ("int8", "scale")}
    c_pad, n = codes.shape
    half = pkw.get("half", False)
    l_eff, _, _, L_pad = HC.hist_layout(pkw["L"], half)
    what = f"{name} int8={int8} L={pkw['L']} half={half} n={n} C={c_pad}"
    abs_err = check_hist(torch, HC, what, fn(*args, **kw), codes, heap,
                         stats, pkw, int8)
    k_ms = time_ms(torch, lambda: fn(*args, **kw), 10)
    p_ms = time_ms(torch, lambda: HC.sbh_hist_plain(*args, **pkw), 2)
    lib = _hist_index_add(torch, HC, codes, heap, stats, pkw["base"],
                          pkw["L"], pkw["n_bins"], half)
    l_ms = time_ms(torch, lib, 2)
    del lib
    torch.cuda.empty_cache()
    # bytes this data needs: every heap id, then the codes and the three
    # used stats of the rows the level sums (left children with half), and
    # the output once
    rows_in = _rows_in(heap, pkw["base"], pkw["L"], half)
    nbytes = 4 * n + rows_in * (c_pad + 12) + L_pad * c_pad * 4 * \
        pkw["n_bins"] * 4
    b_ms, by = _bound_ms(nbytes, 3 * c_pad * rows_in)
    groups = ""
    if name == "sbh_hist_dense" and not int8:
        groups = "; " + time_groups(
            torch, HC, lambda g: fn(*args, **kw, group=g), l_eff, c_pad,
            pkw["n_bins"])
    elif name == "sbh_hist_dense":
        groups = "; layouts " + time_layouts(
            torch, lambda **v: fn(*args, **kw, **v),
            i8_dense_layouts(HC, l_eff, pkw["n_bins"], c_pad, n))
    elif name == "sbh_hist_radix":
        slot = l_eff * 3 * (4 if int8 else 8) * pkw["n_bins"]
        groups = "; layouts " + time_layouts(torch, lambda **v: fn(
            *args, **kw, **v), [
            (f"G={g} T={t} agg={int(a)} copies="
             f"{HC.radix_grid(l_eff, pkw['n_bins'], c_pad, int8, g, t)[2]}",
             dict(group=g, threads=t, agg=a))
            for g in HC.RADIX_GROUPS[int8] if g <= c_pad and g * slot <= HC.SMEM_MAX
            for t in (512, 1024) for a in (True, False)])
    level = (pkw["L"] - 1).bit_length()
    say(f"timing {what} (level {level}): kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({by}, {rows_in} rows summed of {l_eff} slots){groups}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms, bound_ms=b_ms,
                bound_by=by, max_abs_err=abs_err)


def i8_dense_layouts(HC, l_eff, n_bins, c_pad, n):
    """(label, layout) of the int8 dense launch at a level of l_eff slots,
    the default first: each window width (the level in one pass, two or
    four) with the widest column group it leaves room for, at 512 and
    1024 threads; the default without the bank padding; and 2 and 4 waves
    of blocks."""
    def label(v):
        win, n_win, g, nt, spad, rows = HC.dense_i8_grid(
            min(l_eff, HC.I8_BAND), n_bins, c_pad, n_pad=n, **v)
        return (f"win={win}x{n_win} G={g} T={nt} spad={spad} "
                f"rows/block={rows}")
    out = [{}]
    for win in sorted({l_eff, max(1, l_eff // 2), max(1, l_eff // 4)},
                      reverse=True):
        out += [dict(win=win, threads=t) for t in (512, 1024)]
    out += [dict(spad=0), dict(waves=2), dict(waves=4)]
    return [(label(v), v) for v in out]


def time_groups(torch, HC, run, l_eff, c_pad, n_bins):
    """Time an f32 dense or fused launch, run(group), at one column per
    block (the widest window), two, and the column groups that a 96 KB and
    the largest shared-memory budget give at the default window; every
    grouping's histogram must equal the first's bit for bit (fixed-point
    sums are exact). Returns the times as text."""
    win = HC.level_grid(l_eff, n_bins, c_pad, False)[0]
    gs = sorted({1, min(2, c_pad),
                 HC.column_group(win, n_bins, c_pad, 96 * 1024),
                 HC.column_group(win, n_bins, c_pad, HC.SMEM_MAX)})
    return "columns per block " + time_layouts(
        torch, lambda group: run(group),
        [(f"G={g}", dict(group=g)) for g in gs])


def time_layouts(torch, run, layouts, reps=10, ref=None):
    """Time run(**kw) for each (label, kw) of `layouts`, each result held
    equal bit for bit to `ref`, or to the first layout's (exact sums do not
    depend on the layout). Returns the times as text."""
    parts, against = [], "the reference" if ref is not None else \
        layouts[0][0]
    for label, kw in layouts:
        out = run(**kw)
        if ref is None:
            ref = out
        check(bit_equal(torch, out, ref), f"layout {label}: result "
              f"differs from {against}")
        parts.append(f"{label} {time_ms(torch, lambda: run(**kw), reps):.4f}"
                     " ms")
    return ", ".join(parts) + " (bit-identical)"


def time_route(torch, HC, args, kw):
    emit_f = kw.get("emit_f", False)
    codes, heap, tbl, route_f = args[:4]
    n = heap.numel()
    h_k, f_k = HC.sbh_route(*args, **kw)
    h_p, f_p = HC.sbh_route_plain(*args, **kw)
    torch.cuda.synchronize()
    check(torch.equal(h_k, h_p), f"route L={kw['L']}: heap differs")
    ferr = (f_k - f_p).abs().max().item() if emit_f else 0.0
    check(ferr < F_ATOL, f"route L={kw['L']}: F err {ferr}")
    k_ms = time_ms(torch, lambda: HC.sbh_route(*args, **kw), 20)
    p_ms = time_ms(torch, lambda: HC.sbh_route_plain(*args, **kw), 3)
    # bytes this data needs: heap in and out, one code byte for each row
    # of a leaf that split, the tables, and F in and out with emit_f
    moved = _rows_routed(heap, tbl, kw["base"], kw["L"])
    nbytes = 8 * n + moved + tbl.numel() * 4 + route_f.numel() * 4
    if emit_f:
        nbytes += 8 * n + args[4].numel() * 4
    b_ms, by = _bound_ms(nbytes, (2 if emit_f else 0) * n)
    sectors = _sectors_touched(torch, codes, heap, tbl, kw["base"], kw["L"])
    layouts = ""
    if not emit_f:
        layouts = "; layouts " + time_layouts(
            torch, lambda **v: HC.sbh_route(*args, **kw, **v)[0],
            [(f"rows={r} T={t}", dict(rows=r, threads=t))
             for r in (4, 8) for t in (256, 512, 1024)], reps=20,
            ref=h_p)
    say(f"timing route L={kw['L']} emit_f={emit_f} n={n}: kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
        f"rows routed {moved}, code sectors touched {sectors} ({sectors * 32} "
        f"B; with the heap {(8 * n + sectors * 32) / HBM_BYTES_S * 1e3:.4f} "
        f"ms at {HBM_BYTES_S / 1e12:.2f} TB/s); heap identical, F err "
        f"{ferr:.3g}{layouts}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                bound_by=by, max_abs_err=ferr)


def _sectors_touched(torch, codes, heap, tbl, base, L):
    """32-byte sectors of the code planes that a route's gathers touch:
    distinct (split column, row // 32) over the rows of leaves that
    split."""
    n = heap.numel()
    leaf = heap.long() - base
    active = (leaf >= 0) & (leaf < L)
    lc = leaf.clamp(0, L - 1)
    did = active & (tbl[1, lc] > 0.5)
    col = tbl[0, lc].long().clamp(0, codes.shape[0] - 1)
    rows = torch.arange(n, device=heap.device)
    return int(torch.unique(((col * n + rows) // 32)[did]).numel())


def time_fused(torch, HC, args, kw):
    codes, heap, tbl, route_f, stats = args
    int8 = bool(kw.get("int8", False))
    pkw = {k: v for k, v in kw.items() if k not in ("int8", "scale")}
    c_pad, n = codes.shape
    l_eff = (pkw["L_h"] + 1) // 2
    what = f"fused int8={int8} L_h={pkw['L_h']} n={n} C={c_pad}"
    h_k, got = HC.sbh_route_hist_fused(*args, **kw)
    abs_err = check_fused(torch, HC, what, h_k, got, args, pkw, int8)
    del got
    k_ms = time_ms(torch, lambda: HC.sbh_route_hist_fused(*args, **kw), 10)
    p_ms = time_ms(torch, lambda: HC.sbh_route_hist_plain(*args, **pkw), 2)
    # bytes this data needs: the heap read and written, the split column's
    # byte of each row of a split leaf, the tables, the codes and three
    # stats of the rows summed (over the new heap), and the output once
    moved = _rows_routed(heap, tbl, pkw["base_r"], pkw["L_r"])
    rows_in = _rows_in(h_k, pkw["base_h"], pkw["L_h"], True)
    nbytes = (8 * n + moved + tbl.numel() * 4 + route_f.numel() * 4
              + rows_in * (c_pad + 12)
              + l_eff * c_pad * 4 * pkw["n_bins"] * 4)
    b_ms, by = _bound_ms(nbytes, 3 * c_pad * rows_in)
    groups = ""
    if not int8:
        groups = "; " + time_groups(
            torch, HC,
            lambda g: HC.sbh_route_hist_fused(*args, **kw, group=g)[1],
            l_eff, c_pad, pkw["n_bins"])
    else:
        # the int8 form's compile-time groups: one column, and the groups
        # of a 96 KB and the largest budget, at 512 and 1024 threads
        win = HC.level_grid(l_eff, pkw["n_bins"], c_pad, True)[0]
        gs = sorted({1} | {min(32, HC._pow2_floor(HC.column_group(
            win, pkw["n_bins"], c_pad, b, 4))) for b in (96 * 1024,
                                                        HC.SMEM_MAX)})
        groups = "; layouts " + time_layouts(
            torch, lambda **v: HC.sbh_route_hist_fused(*args, **kw, **v)[1],
            [(f"G={g} T={t}", dict(group=g, threads=t))
             for g in gs for t in (512, 1024)])
    say(f"timing {what}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({by}, {moved} rows routed, {rows_in} rows summed "
        f"of {l_eff} slots){groups}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=None, bound_ms=b_ms,
                bound_by=by, max_abs_err=abs_err)


def _summary(rs):
    """One kernels-JSON entry's numbers from one tree's launches: means,
    the largest error, what bounds most of them."""
    mean = lambda k: float(np.mean([r[k] for r in rs]))  # noqa: E731
    lib = [r["library_ms"] for r in rs]
    return {"max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            "bound_by": max(("bytes", "operations"),
                            key=[r["bound_by"] for r in rs].count),
            "library_ms": None if lib[0] is None else float(np.mean(lib))}


def phase_timing(torch, HC, runs):
    """Every kernel at the shapes of one tree of the HIGGS runs and of run
    (d) (Covertype width, C_pad 56), and the dense histogram and route
    launches of levels 8 and 9 of a run (f) tree with its terminal route.
    The kernels-JSON entries come from run (b), the default configuration,
    and for sbh_hist_i8 from run (c); the other runs' launches are printed
    beside them."""
    rows = {}
    for run in ("a", "b", "c", "d"):
        launches, calls = runs[run]
        rs = {}
        rs["sbh_hist"] = [time_hist(torch, HC, "sbh_hist_dense", a, k)
                          for a, k in calls["sbh_hist_dense"]]
        rs["sbh_hist_radix"] = [time_hist(torch, HC, "sbh_hist_radix", a, k)
                                for a, k in calls["sbh_hist_radix"]]
        rs["sbh_route_hist_fused"] = [
            time_fused(torch, HC, a, k)
            for a, k in calls["sbh_route_hist_fused"]]
        route = [time_route(torch, HC, a, k) for a, k in calls["sbh_route"]]
        rs["sbh_route"] = route[:-1]
        rs["sbh_route_emit_f"] = route[-1:]
        if run == "c":
            rs["sbh_hist_i8"] = rs.pop("sbh_hist")
        rs = {k: v for k, v in rs.items() if v}
        per_tree = sum(r["ms"] for v in rs.values() for r in v)
        parts = ", ".join(f"{k} {sum(r['ms'] for r in v):.4f} ms/{len(v)}"
                          for k, v in rs.items())
        say(f"kernel time of one tree, run ({run}): {per_tree:.4f} ms "
            f"({parts})")
        rows[run] = (launches, rs)
    # run (f): the dense histogram of levels 8 and 9 (256 and 512 leaves,
    # left children summed), their routes and the terminal route (L 512)
    _, calls = runs["f"]
    deep = [time_hist(torch, HC, "sbh_hist_dense", a, k)
            for a, k in calls["sbh_hist_dense"][2:]]
    route = [time_route(torch, HC, a, k) for a, k in calls["sbh_route"][2:]]
    say(f"kernel time of levels 8-9 of one tree, run (f): sbh_hist "
        f"{sum(r['ms'] for r in deep):.4f} ms/{len(deep)} (bound "
        f"{sum(r['bound_ms'] for r in deep):.4f}), sbh_route "
        f"{sum(r['ms'] for r in route[:-1]):.4f} ms/{len(route) - 1} (bound "
        f"{sum(r['bound_ms'] for r in route[:-1]):.4f}); the terminal route "
        f"{route[-1]['ms']:.4f} ms (bound {route[-1]['bound_ms']:.4f})")
    counts = {"sbh_route": "route", "sbh_route_emit_f": "route_f",
              "sbh_hist": "hist", "sbh_hist_i8": "hist_i8",
              "sbh_hist_radix": "radix", "sbh_route_hist_fused": "fused"}
    out = []
    for name, key in counts.items():
        launches, rs = rows["c" if name == "sbh_hist_i8" else "b"]
        check(launches[key] > 0, f"{name} never launched on its path")
        out.append({"name": name, "route": "cuda", "source": SOURCE,
                    "replaces": TPU_KERNELS[name], "launches": launches[key],
                    **_summary(rs[name])})
    return out


# ---------------------------------------------------------------------------
def main():
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a card")
    try:
        import h2o3_tpu_torch as h2o
        from h2o3_tpu_torch.ops import _build
        from h2o3_tpu_torch.ops import hist_cuda as HC
    except ImportError as e:
        fail(f"the port is not importable beside this script: {e}")
    # a float32 matmul stays full precision on the card; state it
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = phase_card(torch, _build)
    dev = torch.device("cuda", 0)
    # 32 columns: HIGGS's 28 padded; 56: Covertype's 54, a partial last
    # group in every kernel's column groups
    for c_pad in (32, 56):
        phase_kernels_small(torch, HC, dev, c_pad)
        phase_adversarial(torch, HC, dev, c_pad)
    phase_small_path(torch, h2o, HC)
    phase_small_adaptive(torch, h2o, HC)
    covtype = phase_covtype(torch, h2o, HC)
    runs = phase_higgs(torch, h2o, HC)
    phase_isofor(torch, h2o, HC)
    runs["d"] = covtype
    kernels = phase_timing(torch, HC, runs)
    recap = [line for line in LOG if RECAP.match(line)]
    say(f"recap of runs (d)-(j) and the (d)-(f) kernels' timings "
        f"({len(recap)} lines, as printed above):")
    for line in recap:
        print(f"  {line}", flush=True)
    say(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
