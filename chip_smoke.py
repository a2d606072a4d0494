#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (h2o3_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its lines before the last:
  1. the card (nvidia-smi name and power limit, torch's device name) and
     the kernels' build: every csrc/*.cu compiled by nvcc for sm_90a, all
     sources at once;
  2. each kernel against its plain PyTorch version on the card (for the
     histogram, the plain version in float64), at small shapes: route with and without the margin update, histogram with
     half False and True at L = 1, 64 and 128;
  3. the main path at small size: a seeded CSV through import_file, a
     bernoulli GBM, predict and AUC, on the card and on the CPU (plain
     versions), which must agree;
  4. the main path at full width: a HIGGS-shaped frame (11M rows x 28
     features, made on the card from a seeded torch.Generator), GBM with
     10 trees of depth 8 over 255 bins through the estimator, predict and
     AUC; launch counts per tree, throughput and peak memory; then a
     second training run with a stopwatch on each estimator stage;
  5. each kernel at the shapes of one tree of that run: its time from CUDA
     events beside its plain version's, one PyTorch library call's where
     there is one, and its bound (the bytes that tree's data needs, each
     input read once and each output written once, over 3.35 TB/s, or its
     f32 operations over 67 TFLOP/s, whichever is larger), and its
     agreement with the plain version on those inputs.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Any failed phase exits non-zero. Without a
CUDA card, or without the rest of the repository beside it, the script
exits non-zero before printing a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
HIST_RTOL = 1e-4      # f32 sums in another order (atomics on the card)
F_ATOL = 1e-5         # one f32 multiply-add
TPU_KERNELS = {
    "sbh_route": "h2o3_tpu/ops/hist_pallas.py:425",
    "sbh_route_emit_f": "h2o3_tpu/ops/hist_pallas.py:458",
    "sbh_hist": "h2o3_tpu/ops/hist_pallas.py:574",
}
SOURCE = "h2o3_tpu_torch/ops/csrc/hist.cu"
HIGGS_N, HIGGS_C, HIGGS_TREES, HIGGS_DEPTH, HIGGS_NBINS = \
    11_000_000, 28, 10, 8, 255


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
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
            if "registers" in line or "spill" in line:
                say(f"ptxas {name}: {line.strip()}")
    return card


def _codes_heap_stats(torch, dev, seed, *, n, c_pad, b_val, L):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n)).astype(np.uint8)
    codes[rng.random((c_pad, n)) < 0.05] = b_val
    base = L - 1
    heap = rng.integers(base, base + L, n).astype(np.int32)
    heap[rng.random(n) < 0.1] = max(0, base - 1)
    stats = rng.normal(0, 1, (4, n)).astype(np.float32)
    stats[3] = 0.0
    return (torch.from_numpy(codes).to(dev), torch.from_numpy(heap).to(dev),
            torch.from_numpy(stats).to(dev), base)


def hist_rel_err(got, want):
    """max |got - want| per stat row over that row's max |want|."""
    errs = []
    for s in range(got.shape[2]):
        scale = max(want[:, :, s].abs().max().item(), 1e-30)
        errs.append((got[:, :, s] - want[:, :, s]).abs().max().item() / scale)
    return max(errs)


def phase_kernels_small(torch, HC, dev):
    n, c_pad, n_bins, b_val = 1 << 16, 32, 256, 255
    for emit_f in (False, True):
        L = 64
        codes, heap, _, base = _codes_heap_stats(torch, dev, 1, n=n,
                                                 c_pad=c_pad, b_val=b_val,
                                                 L=L)
        rng = np.random.default_rng(2)
        tbl = np.zeros((8, L), np.float32)
        tbl[0] = rng.integers(0, c_pad, L)
        tbl[1] = rng.random(L) < 0.8
        route_f = (rng.random((L, n_bins)) < 0.5).astype(np.float32)
        valtab = np.zeros((8, 256), np.float32)
        valtab[0] = rng.normal(0, 1, 256)
        F = rng.normal(0, 1, n).astype(np.float32)
        args = [codes, heap] + [torch.from_numpy(a).to(dev)
                                for a in (tbl, route_f, valtab, F)]
        kw = dict(base=base, L=L, eta=0.1, emit_f=emit_f)
        h_k, f_k = HC.sbh_route(*args, **kw)
        h_p, f_p = HC.sbh_route_plain(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(h_k, h_p), f"route emit_f={emit_f}: heap differs")
        ferr = (f_k - f_p).abs().max().item() if emit_f else 0.0
        check(ferr < F_ATOL, f"route emit_f={emit_f}: F err {ferr}")
        say(f"kernel route emit_f={emit_f} n={n}: heap identical, "
            f"F max err {ferr:.3g} (tol {F_ATOL})")
    for L in (1, 64, 128):
        for half in (False, True):
            codes, heap, stats, base = _codes_heap_stats(
                torch, dev, 10 + L, n=n, c_pad=c_pad, b_val=b_val, L=L)
            kw = dict(base=base, L=L, n_bins=n_bins, half=half)
            got = HC.sbh_hist(codes, heap, stats, **kw)
            want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
            torch.cuda.synchronize()
            err = hist_rel_err(got.double(), want)
            check(err <= HIST_RTOL, f"hist L={L} half={half}: rel err {err}")
            say(f"kernel hist L={L} half={half} n={n}: rel err {err:.3g} "
                f"(tol {HIST_RTOL})")


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
    gbm = dict(ntrees=5, max_depth=4, learn_rate=0.2,
               distribution="bernoulli", seed=5)
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
    check(p.shape == (4000, 3) and np.isfinite(p).all(), "bad predictions")
    for k in ("route", "route_f", "hist"):
        check(launches[k] > 0, f"small path never launched {k}: {launches}")
    perr = float(np.abs(p[:, 1:] - cpu_p[:, 1:]).max())
    aerr = abs(m.auc() - cm.auc())
    say(f"small path: 4000 rows csv -> gbm 5x4 -> predict: AUC card "
        f"{m.auc():.6f} cpu {cm.auc():.6f}; pred max err {perr:.3g}; "
        f"launches {launches}")
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


def phase_higgs(torch, h2o, HC):
    from h2o3_tpu_torch.core.frame import Frame, T_CAT, Vec
    dev = h2o.init().device
    N, C = HIGGS_N, HIGGS_C
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    X = torch.randn((N, C), generator=g, device=dev)
    logit = (1.2 * X[:, 0] - 0.8 * X[:, 1] + 0.6 * X[:, 2] * X[:, 3]
             + 0.4 * torch.sin(X[:, 4]) + 0.3 * X[:, 5] * X[:, 6])
    y = (torch.rand(N, generator=g, device=dev)
         < torch.sigmoid(logit)).float()
    names = [f"x{j}" for j in range(C)] + ["y"]
    vecs = [Vec.from_tensor(X[:, j].contiguous()) for j in range(C)]
    vecs.append(Vec.from_tensor(y, type=T_CAT, domain=["0", "1"]))
    fr = Frame(names, vecs)
    del X, logit, y
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    rec_h = Recorder(HC.sbh_hist, HIGGS_DEPTH)
    rec_r = Recorder(HC.sbh_route, HIGGS_DEPTH)
    real = (HC.sbh_hist, HC.sbh_route)
    HC.sbh_hist, HC.sbh_route = rec_h, rec_r
    try:
        m = h2o.H2OGradientBoostingEstimator(
            ntrees=HIGGS_TREES, max_depth=HIGGS_DEPTH, nbins=HIGGS_NBINS,
            distribution="bernoulli", seed=1)
        HC.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.train(y="y", training_frame=fr)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches = dict(HC.LAUNCHES)
    finally:
        HC.sbh_hist, HC.sbh_route = real
    t0 = time.perf_counter()
    pred = m.predict(fr)
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    p1 = pred.vec("p1").data
    check(pred.nrows == N and bool(torch.isfinite(p1).all()),
          "HIGGS predictions not finite")
    auc = m.auc()
    per_tree = {k: v / HIGGS_TREES for k, v in launches.items()}
    say(f"higgs: {N} rows x {C} features, {HIGGS_TREES} trees depth "
        f"{HIGGS_DEPTH} nbins {HIGGS_NBINS}: train {t_train:.3f} s "
        f"({N * HIGGS_TREES / t_train:.0f} row*trees/s), predict "
        f"{t_pred:.3f} s, train AUC {auc:.6f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say(f"higgs launches per tree: {per_tree} (expected hist "
        f"{HIGGS_DEPTH}, route {HIGGS_DEPTH - 1}, route_f 1)")
    check(auc > 0.7, f"HIGGS train AUC {auc}")
    check(per_tree == {"hist": HIGGS_DEPTH, "route": HIGGS_DEPTH - 1,
                       "route_f": 1}, f"launches per tree {per_tree}")
    check(len(rec_h.calls) == HIGGS_DEPTH and len(rec_r.calls) == HIGGS_DEPTH,
          "did not capture one tree's kernel inputs")
    breakdown(torch, h2o, fr)
    return launches, rec_h.calls, rec_r.calls


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


def breakdown(torch, h2o, fr):
    """A second HIGGS training run with a stopwatch on each stage of the
    estimator (the syncs make it a little slower than the run above)."""
    from h2o3_tpu_torch.models import model as MB
    from h2o3_tpu_torch.models.tree import binned as BN
    from h2o3_tpu_torch.models.tree import shared_tree as ST
    stages = [(MB.ModelBase, "_resolve_predictors"),
              (ST.SharedTreeEstimator, "_binned_setup"),
              (BN.BinnedGrower, "grow"), (BN, "find_splits_binned"),
              (ST.SharedTreeEstimator, "_record_history"),
              (MB.ModelBase, "_score_train_valid")]
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
        m = h2o.H2OGradientBoostingEstimator(
            ntrees=HIGGS_TREES, max_depth=HIGGS_DEPTH, nbins=HIGGS_NBINS,
            distribution="bernoulli", seed=1)
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
    say(f"higgs train breakdown: total {total:.3f} s; {parts} "
        "(find_splits_binned runs inside grow)")


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
    flattened (slot, column, bin) index of every (row, column). Returns
    the call; building its index is set-up, not timed."""
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
    out = torch.zeros(((L_pad + 1) * c_pad * n_bins, 3), device=codes.device)
    return lambda: out.index_add_(0, idx, src)


def phase_timing(torch, HC, launches, hist_calls, route_calls):
    rows = {k: [] for k in TPU_KERNELS}
    for d, (args, kw) in enumerate(hist_calls):
        codes, heap, stats = args
        c_pad, n = codes.shape
        _, _, _, L_pad = HC.hist_layout(kw["L"], kw.get("half", False))
        got = HC.sbh_hist(*args, **kw)
        # the plain version in float64 is the reference here: its f32 sums
        # run sequentially over ~43k rows per bin at 11M rows and lose
        # about n*eps (~3e-3) themselves; that gap is printed beside it
        want = HC.sbh_hist_plain(codes, heap, stats.double(), **kw)
        want32 = HC.sbh_hist_plain(*args, **kw)
        torch.cuda.synchronize()
        err = hist_rel_err(got.double(), want)
        err32 = hist_rel_err(want32.double(), want)
        abs_err = (got.double() - want).abs().max().item()
        check(err <= HIST_RTOL, f"hist level {d} at HIGGS shape: rel err {err}")
        del got, want, want32
        k_ms = time_ms(torch, lambda: HC.sbh_hist(*args, **kw), 10)
        p_ms = time_ms(torch, lambda: HC.sbh_hist_plain(*args, **kw), 2)
        lib = _hist_index_add(torch, HC, codes, heap, stats, kw["base"], kw["L"],
                              kw["n_bins"], kw.get("half", False))
        l_ms = time_ms(torch, lib, 2)
        del lib
        torch.cuda.empty_cache()
        # bytes this data needs: every heap id, then the codes and the three
        # used stats of the rows the level sums (left children with half),
        # and the output once
        l_eff = HC.hist_layout(kw["L"], kw.get("half", False))[0]
        leaf = heap.long() - kw["base"]
        inw = (leaf >= 0) & (leaf < kw["L"])
        if kw.get("half", False):
            inw &= (leaf & 1) == 0
        rows_in = int(inw.sum().item())
        nbytes = (4 * n + rows_in * (c_pad + 12)
                  + L_pad * c_pad * 4 * kw["n_bins"] * 4)
        b_ms, by = _bound_ms(nbytes, 3 * c_pad * rows_in)
        rows["sbh_hist"].append(dict(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                                     bound_ms=b_ms, bound_by=by,
                                     max_abs_err=abs_err))
        say(f"timing hist level {d} L={kw['L']} half={kw.get('half', False)}"
            f" n={n} C={c_pad}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"index_add_ {l_ms:.4f} ms, bound {b_ms:.4f} ms ({by}, "
            f"{rows_in} rows summed of {l_eff} slots); "
            f"rel err vs f64 plain {err:.3g} (f32 plain: {err32:.3g})")
    for d, (args, kw) in enumerate(route_calls):
        emit_f = kw.get("emit_f", False)
        codes, heap, tbl, route_f = args[:4]
        n = heap.numel()
        h_k, f_k = HC.sbh_route(*args, **kw)
        h_p, f_p = HC.sbh_route_plain(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(h_k, h_p), f"route level {d}: heap differs")
        ferr = (f_k - f_p).abs().max().item() if emit_f else 0.0
        check(ferr < F_ATOL, f"route level {d}: F err {ferr}")
        k_ms = time_ms(torch, lambda: HC.sbh_route(*args, **kw), 20)
        p_ms = time_ms(torch, lambda: HC.sbh_route_plain(*args, **kw), 3)
        # bytes this data needs: heap in and out, one code byte for each
        # row of a leaf that split, the tables, and F in and out with emit_f
        leaf = heap.long() - kw["base"]
        active = (leaf >= 0) & (leaf < kw["L"])
        did = tbl[1, leaf.clamp(0, kw["L"] - 1)] > 0.5
        moved = int((active & did).sum().item())
        nbytes = 8 * n + moved + tbl.numel() * 4 + route_f.numel() * 4
        if emit_f:
            nbytes += 8 * n + args[4].numel() * 4
        b_ms, by = _bound_ms(nbytes, (2 if emit_f else 0) * n)
        key = "sbh_route_emit_f" if emit_f else "sbh_route"
        rows[key].append(dict(ms=k_ms, plain_ms=p_ms, library_ms=None,
                              bound_ms=b_ms, bound_by=by, max_abs_err=ferr))
        say(f"timing route level {d} L={kw['L']} emit_f={emit_f} n={n}: "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({by}), rows routed {moved}; heap identical, F err {ferr:.3g}")
    per_tree = sum(r["ms"] for rs in rows.values() for r in rs)
    say(f"kernel time of one tree: {per_tree:.4f} ms "
        f"(hist {sum(r['ms'] for r in rows['sbh_hist']):.4f} ms, route "
        f"{sum(r['ms'] for r in rows['sbh_route']):.4f} ms, route_f "
        f"{sum(r['ms'] for r in rows['sbh_route_emit_f']):.4f} ms)")
    counts = {"sbh_route": launches["route"],
              "sbh_route_emit_f": launches["route_f"],
              "sbh_hist": launches["hist"]}
    out = []
    for name, rs in rows.items():
        mean = lambda k: float(np.mean([r[k] for r in rs]))  # noqa: E731
        lib = [r["library_ms"] for r in rs]
        out.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[name], "launches": counts[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"),
            # what bounds most of the tree's launches of this kernel
            "bound_by": max(("bytes", "operations"),
                            key=[r["bound_by"] for r in rs].count),
            "library_ms": None if lib[0] is None else float(np.mean(lib)),
        })
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
    phase_kernels_small(torch, HC, dev)
    phase_small_path(torch, h2o, HC)
    launches, hist_calls, route_calls = phase_higgs(torch, h2o, HC)
    kernels = phase_timing(torch, HC, launches, hist_calls, route_calls)
    say(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
