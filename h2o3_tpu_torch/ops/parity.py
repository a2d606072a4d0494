"""Kernel parity gate: the CUDA kernels of ops/hist_cuda.py against their
plain PyTorch versions.

The CPU tests reach only the plain versions (a wrapper given a CPU tensor
runs its plain version), so a misrouting kernel could ship behind a good
throughput number. `kernel_parity_check` launches every kernel on the
card on random numeric, categorical-set and NA inputs and holds each
result against its plain version on the same inputs:

- heap ids bit for bit (the route with and without the margin F, over a
  categorical-set table and a numeric one with its NA direction; the
  fused route+histogram);
- int32 histograms (the int8 forms) equal;
- f32 histograms against the plain version summed in float64, within
  HIST_RTOL of each stat row's largest entry (the kernels sum in exact
  64-bit fixed point and round once to f32);
- F within F_ATOL (one f32 multiply-add).

On a CPU tensor there is no kernel to hold, so the check raises rather
than compare a plain version with itself.
"""

from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.ops import hist_cuda as HC

HIST_RTOL = 1e-4
F_ATOL = 1e-5
N_ROWS = 1 << 16


def _rand_arrays(seed=0, n_pad=N_ROWS, c_pad=32, b_val=64, L=8):
    """uint8 codes with a 5% NA code (b_val), f32 stats (row 3 zero) and
    heap ids spread over [base, base+L): the JAX package's draws."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n_pad)).astype(np.uint8)
    codes[rng.random((c_pad, n_pad)) < 0.05] = b_val          # NA code
    base = L - 1
    heap = rng.integers(base, base + L, n_pad).astype(np.int32)
    stats = rng.normal(0, 1, (HC.S_STATS, n_pad)).astype(np.float32)
    stats[3] = 0.0
    return codes, heap, stats, base


def _int8_arrays(seed, shape):
    """int32 stats in [-127, 127] (the int8 kernels' inputs)."""
    return np.random.default_rng(seed).integers(-127, 128, shape) \
        .astype(np.int32)


def _route_arrays(rng, L, n_bins, b_val, c_pad):
    """Split tables as the JAX package draws them: tbl rows 0-3 (split
    column, did-split, numeric split bin, NA goes left), a
    categorical-set table (each bin right at random) and the numeric one
    (a bin right past the split bin, the NA code by the NA direction)."""
    Lp = max(8, L)
    tbl = np.zeros((8, Lp), np.float32)
    tbl[0, :L] = rng.integers(0, c_pad, L)
    tbl[1, :L] = rng.random(L) < 0.8
    tbl[2, :L] = rng.integers(0, b_val - 1, L)       # numeric split bin
    tbl[3, :L] = rng.random(L) < 0.5                 # NA goes left
    route_cat = (rng.random((Lp, n_bins)) < 0.5).astype(np.float32)
    route_num = np.zeros((Lp, n_bins), np.float32)
    route_num[:L] = (np.arange(n_bins)[None, :] > tbl[2, :L, None])
    route_num[:L, b_val] = 1.0 - tbl[3, :L]
    return tbl, route_cat, route_num


def _on(device, *arrays):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def _hist_rel_err(got, want):
    """max |got - want| of each stat row over that row's max |want|."""
    err = 0.0
    for s in range(want.shape[2]):
        scale = max(float(want[:, :, s].abs().max()), 1e-30)
        err = max(err, float((got[:, :, s].double() - want[:, :, s])
                             .abs().max()) / scale)
    return err


def _held(devs, key, got, want, int8):
    """Record and assert one histogram's deviation."""
    assert got.shape == want.shape, (key, tuple(got.shape),
                                     tuple(want.shape))
    if int8:
        d = int((got.long() - want.long()).abs().max())
        assert got.dtype == torch.int32 and d == 0, (key, d)
    else:
        d = _hist_rel_err(got, want)
        assert d <= HIST_RTOL, (key, d)
    devs[key] = d


def kernel_parity_check(seed=0, device=None, c_pad=32):
    """Assert kernel == plain for the dense histogram (f32 with half
    False and True, and int8), the shallow-window histogram (its windows,
    f32 and int8), the route with and without the F stream (categorical
    sets and numeric thresholds) and the fused route+histogram (f32 and
    int8), at `c_pad` code columns. Returns the dict of largest
    deviations: relative for f32 histograms, absolute otherwise."""
    dev = torch.device(device) if device is not None \
        else torch.device("cuda", 0)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"kernel_parity_check holds the CUDA kernels: "
                           f"device {dev} has none")
    n_bins, b_val, L = 128, 64, 8
    codes, heap, stats, base = _rand_arrays(seed, c_pad=c_pad, b_val=b_val,
                                            L=L)
    si = _int8_arrays(seed + 1, stats.shape)
    codes, heap, stats, si = _on(dev, codes, heap, stats, si)
    stats64 = stats.double()
    devs = {}
    for half in (False, True):
        kw = dict(base=base, L=L, n_bins=n_bins, half=half)
        _held(devs, f"hist_half={half}",
              HC.sbh_hist_dense(codes, heap, stats, **kw),
              HC.sbh_hist_plain(codes, heap, stats64, **kw), False)
        _held(devs, f"i8_half={half}",
              HC.sbh_hist_dense(codes, heap, si, int8=True, **kw),
              HC.sbh_hist_plain(codes, heap, si, **kw), True)

    # the shallow-window kernel over its whole regime: windows of one and
    # two leaves, full and half, f32 and int8, 256 bins
    codes2, heap2, stats2, _ = _rand_arrays(seed + 3, c_pad=c_pad,
                                            b_val=255, L=4)
    si2 = _int8_arrays(seed + 4, stats2.shape)
    codes2, heap2, stats2, si2 = _on(dev, codes2, heap2, stats2, si2)
    for Lw, half in ((1, False), (2, False), (2, True), (4, True)):
        hw = heap2 % Lw + (Lw - 1)
        kw = dict(base=Lw - 1, L=Lw, n_bins=256, half=half)
        _held(devs, f"radix_L={Lw}_half={half}",
              HC.sbh_hist_radix(codes2, hw, stats2, **kw),
              HC.sbh_hist_plain(codes2, hw, stats2.double(), **kw), False)
        _held(devs, f"radix_i8_L={Lw}_half={half}",
              HC.sbh_hist_radix(codes2, hw, si2, int8=True, **kw),
              HC.sbh_hist_plain(codes2, hw, si2, **kw), True)

    rng = np.random.default_rng(seed + 2)
    tbl, route_cat, route_num = _on(
        dev, *_route_arrays(rng, L, n_bins, b_val, c_pad))
    nodes_p = -(-(2 * (base + L) + 1) // 128) * 128
    valtab = np.zeros((8, nodes_p), np.float32)
    valtab[0] = rng.normal(0, 1, nodes_p)
    valtab = torch.from_numpy(valtab).to(dev)
    F = torch.from_numpy(rng.normal(0, 1, codes.shape[1])
                         .astype(np.float32)).to(dev)
    for any_cat, route_f in ((True, route_cat), (False, route_num)):
        kw = dict(base=base, L=L, eta=0.1)
        h_k, f_k = HC.sbh_route(codes, heap, tbl, route_f, valtab, F,
                                emit_f=True, **kw)
        h_p, f_p = HC.sbh_route_plain(codes, heap, tbl, route_f, valtab, F,
                                      emit_f=True, **kw)
        dh = int((h_k.long() - h_p.long()).abs().max())
        df = float((f_k - f_p).abs().max())
        devs[f"route_cat={any_cat}_heap"] = dh
        devs[f"route_cat={any_cat}_F"] = df
        assert dh == 0, (any_cat, dh)  # routing must be bit-identical
        assert df < F_ATOL, (any_cat, df)
        # the non-terminal route: heap ids only, no F stream
        h_k2, f_none = HC.sbh_route(codes, heap, tbl, route_f, **kw)
        dh2 = int((h_k2.long() - h_p.long()).abs().max())
        devs[f"route_cat={any_cat}_noF_heap"] = dh2
        assert f_none is None and dh2 == 0, (any_cat, dh2)

    # the fused route+histogram against the sequential plain pair: route
    # leaves [base_r, base_r+L_r), then the half histogram of
    # [base_h, base_h+L_h) over the new heap
    si3 = _on(dev, _int8_arrays(seed + 5, tuple(stats.shape)))[0]
    for L_h in (2, 8, 32):
        L_r = L_h >> 1
        base_r, base_h = L_r - 1, L_h - 1
        hw = heap % L_r + base_r
        tblr, rcat, _ = _on(dev, *_route_arrays(rng, L_r, n_bins, b_val,
                                                c_pad))
        kw = dict(base_r=base_r, L_r=L_r, base_h=base_h, L_h=L_h,
                  n_bins=n_bins)
        for int8, st in ((False, stats), (True, si3)):
            nh_k, hist_k = HC.sbh_route_hist_fused(codes, hw, tblr, rcat, st,
                                                   int8=int8, **kw)
            nh_p, hist_p = HC.sbh_route_hist_plain(
                codes, hw, tblr, rcat, st if int8 else st.double(), **kw)
            tag = f"fused{'_i8' if int8 else ''}_L={L_h}"
            dh = int((nh_k.long() - nh_p.long()).abs().max())
            devs[f"{tag}_heap"] = dh
            assert dh == 0, (tag, dh)
            _held(devs, f"{tag}_hist", hist_k, hist_p, int8)
    torch.cuda.synchronize(dev)
    return devs
