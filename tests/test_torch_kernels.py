"""The port's route and histogram passes against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions and the JAX
package runs its XLA twins (`sbh_route_xla`, `sbh_hist_xla`), since Pallas
only runs on a TPU. Inputs are made from a seed with numpy and handed to
both. Tolerances: routed heap ids are bit-identical (integer arithmetic);
the margin update within 1e-5 (one f32 multiply-add); histograms within
1e-4 of each stat row's largest magnitude (f32 sums in another order).

The CUDA kernels themselves are held against these plain versions on a
card by tests/test_torch_gpu.py and chip_smoke.py.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops import hist_pallas as HP
from h2o3_tpu.ops.parity import _route_tables
from h2o3_tpu_torch.ops import hist_cuda as HC

HIST_RTOL = 1e-4
F_ATOL = 1e-5


def _codes_heap_stats(seed, *, n_pad=4096, c_pad=16, b_val=64, L=8):
    """uint8 codes with NA codes, a heap spread over the level's leaves
    plus rows of other levels, and stats with row 3 zero."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, b_val, (c_pad, n_pad)).astype(np.uint8)
    codes[rng.random((c_pad, n_pad)) < 0.05] = b_val
    base = L - 1
    heap = rng.integers(base, base + L, n_pad).astype(np.int32)
    heap[rng.random(n_pad) < 0.1] = max(0, base - 1)     # frozen rows
    stats = rng.normal(0, 1, (HP.S_STATS, n_pad)).astype(np.float32)
    stats[3] = 0.0
    return codes, heap, stats, base


def _hist_rel_err(got, want):
    """max |got - want| over each stat row, over that row's max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    errs = []
    for s in range(HP.S_STATS):
        scale = max(np.abs(want[:, :, s]).max(), 1e-30)
        errs.append(np.abs(got[:, :, s] - want[:, :, s]).max() / scale)
    return max(errs)


@pytest.mark.parametrize("emit_f", [False, True])
@pytest.mark.parametrize("any_cat", [True, False])
def test_route_matches_jax(any_cat, emit_f):
    L, n_bins, b_val = 8, 128, 64
    codes, heap, _, base = _codes_heap_stats(3, L=L, b_val=b_val)
    rng = np.random.default_rng(4)
    tbl, route_cat, route_num = (np.array(a) for a in _route_tables(
        rng, L, n_bins, b_val, codes.shape[0]))
    route_f = route_cat if any_cat else route_num
    valtab = np.concatenate([rng.normal(0, 1, (1, 128)),
                             np.zeros((7, 128))]).astype(np.float32)
    F = rng.normal(0, 1, codes.shape[1]).astype(np.float32)
    kw = dict(base=base, L=L, eta=0.1, emit_f=emit_f)
    h_x, f_x = HP.sbh_route_xla(
        jnp.asarray(codes), jnp.asarray(heap), jnp.asarray(tbl),
        jnp.asarray(route_f), jnp.asarray(valtab), jnp.asarray(F),
        any_cat=any_cat, na_code=b_val, **kw)
    h_t, f_t = HC.sbh_route(
        torch.from_numpy(codes), torch.from_numpy(heap),
        torch.from_numpy(tbl), torch.from_numpy(route_f),
        torch.from_numpy(valtab), torch.from_numpy(F), **kw)
    assert h_t.dtype == torch.int32
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_x))
    assert (h_t.numpy() != heap).any()             # some rows did move
    if emit_f:
        assert np.abs(f_t.numpy() - np.asarray(f_x)).max() < F_ATOL
    else:
        assert f_t is None


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("L", [1, 2, 8, 128])
def test_hist_matches_jax(L, half):
    n_bins, b_val = 128, 64
    codes, heap, stats, base = _codes_heap_stats(5 + L, L=L, b_val=b_val)
    want = np.asarray(HP.sbh_hist_xla(
        jnp.asarray(codes), jnp.asarray(heap), jnp.asarray(stats),
        base=base, L=L, n_bins=n_bins, half=half))
    got = HC.sbh_hist(torch.from_numpy(codes), torch.from_numpy(heap),
                      torch.from_numpy(stats), base=base, L=L,
                      n_bins=n_bins, half=half)
    assert tuple(got.shape) == want.shape
    _, _, npass, L_pad = HC.hist_layout(L, half)
    assert got.shape[0] == L_pad
    if L == 128 and not half:
        assert npass == 2                          # two 64-leaf windows
    assert not got[:, :, 3].any()                  # spare stat row stays 0
    assert _hist_rel_err(got.numpy(), want) <= HIST_RTOL


def test_wrappers_refuse_other_devices():
    codes = torch.zeros((8, 512), dtype=torch.uint8, device="meta")
    heap = torch.zeros(512, dtype=torch.int32, device="meta")
    stats = torch.zeros((4, 512), device="meta")
    with pytest.raises(ValueError, match="no route/hist implementation"):
        HC.sbh_hist(codes, heap, stats, base=0, L=1, n_bins=128)


def test_kernel_source_notes_and_entry_points():
    """Each kernel carries its note (the TPU kernel it replaces and what
    bounds it) and the C entry points the wrappers bind exist."""
    src = (pathlib.Path(HC.__file__).parent / "csrc" / "hist.cu").read_text()
    for needle in ("replaces hist_pallas.py sbh_route_pallas",
                   "replaces hist_pallas.py sbh_hist_pallas",
                   "Bound: bytes", "int h2o3_route(", "int h2o3_hist(",
                   "cudaGetLastError()"):
        assert needle in src
    tree = ast.parse(pathlib.Path(HC.__file__).read_text())
    names = {n.name for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    assert {"sbh_route", "sbh_route_plain", "sbh_hist",
            "sbh_hist_plain"} <= names
