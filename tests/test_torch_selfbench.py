"""utils/selfbench.py and ops/parity.py of the port against the JAX
package's, on the CPU.

- selfbench: `run_all()` returns the JAX package's keys (top level and a
  network row's), each rate positive and finite, published under the
  same `h2o3_selfbench` series and label schema; /3/NetworkTest answers
  from the same reduction (`network_bench`);
- parity: the gate's inputs are the JAX gate's draws (codes, heap ids,
  stats and split tables equal for the same seed), the plain versions it
  holds the kernels against equal the JAX XLA twins on them (heap ids
  exactly, f32 histograms within 1e-5 of each stat row's scale: both
  sum in f32 in another order, int32 sums of stat rows 0-2 equal), and
  `kernel_parity_check` raises on the CPU instead of holding a plain
  version against itself.
"""

import math

import numpy as np
import pytest
import torch

import h2o3_tpu_torch
from h2o3_tpu.ops import hist_pallas as JHP
from h2o3_tpu.ops import parity as JP
from h2o3_tpu.utils import selfbench as JSB
from h2o3_tpu_torch.ops import hist_cuda as HC
from h2o3_tpu_torch.ops import parity as TP
from h2o3_tpu_torch.utils import selfbench as TSB

SMALL = dict(linpack_n=128, triad_n=1 << 16)


@pytest.fixture(scope="module")
def cpu_cloud():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def test_run_all_has_the_reference_keys(cpu_cloud, monkeypatch):
    got = TSB.run_all(**SMALL)
    lp, mb = JSB.linpack, JSB.memory_bandwidth
    monkeypatch.setattr(JSB, "linpack", lambda: lp(n=128))
    monkeypatch.setattr(JSB, "memory_bandwidth", lambda: mb(n=1 << 16))
    want = JSB.run_all()
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"linpack_f32"}
    assert set(want["network"][0]) <= set(got["network"][0])
    assert [r["payload_bytes_per_device"] for r in got["network"]] == \
        [r["payload_bytes_per_device"] for r in want["network"]]
    for key in ("linpack", "memory_bandwidth"):
        assert set(want[key]) <= set(got[key])
    assert got["linpack"]["dtype"] == "bfloat16"
    assert got["linpack_f32"]["dtype"] == "float32"
    assert got["linpack_f32"]["tf32"] is False
    assert {r["collective"] for r in got["network"]} == {"none"}
    assert (got["backend"], got["n_devices"]) == ("cpu", 1)
    rates = [got["linpack"]["gflops"], got["linpack_f32"]["gflops"],
             got["memory_bandwidth"]["gbps"]]
    rates += [r["latency_us"] for r in got["network"]]
    rates += [r["algo_bw_gbps"] for r in got["network"]]
    assert all(r > 0 and math.isfinite(r) for r in rates)


def test_publish_uses_the_reference_series(cpu_cloud):
    from h2o3_tpu.obs import metrics as JM
    from h2o3_tpu_torch.obs import metrics as TM
    res = {"linpack": {"gflops": 1.5, "dtype": "bfloat16"},
           "memory_bandwidth": {"gbps": 2.5},
           "network": [{"payload_bytes_per_device": 1024,
                        "latency_us": 3.5, "algo_bw_gbps": 4.5}]}
    JSB.publish(res)
    TSB.publish(res)

    def lines(text):
        return sorted(ln for ln in text.splitlines()
                      if ln.startswith("h2o3_selfbench{")
                      and ('payload_bytes="1024"' in ln
                           or 'dtype="bfloat16"' in ln
                           or 'probe="hbm_triad_gbps"' in ln))
    want = lines(JM.REGISTRY.prometheus_text())
    got = lines(TM.REGISTRY.prometheus_text())
    assert got == want and len(got) == 4


def test_network_test_route_times_network_bench(cpu_cloud, monkeypatch):
    from h2o3_tpu_torch.api import routes_ext as RX
    monkeypatch.setattr(TSB, "device_reduce_seconds",
                        lambda nbytes, dev=None, repeats=5: nbytes * 1e-9)
    sent = {}

    class H:
        def _send(self, body):
            sent.update(body)
    RX._h_network_test(H())
    assert [r["bytes"] for r in sent["results"]] == [1 << 10, 1 << 16,
                                                      1 << 20]
    assert [r["micros"] for r in sent["results"]] == pytest.approx(
        [(1 << 10) * 1e-3, (1 << 16) * 1e-3, (1 << 20) * 1e-3])
    assert {(r["collective"], r["op"]) for r in sent["results"]} == \
        {("none", "device_reduce")}


@pytest.mark.parametrize("c_pad", [16, 32, 56])
def test_parity_inputs_are_the_jax_gates(c_pad):
    import jax.numpy as jnp
    n = 2 * JHP.BLOCK_ROWS
    u8, _, heap, stats, base, L, n_bins, b_val = JP._rand_inputs(
        seed=3, n_pad=n, c_pad=c_pad)
    codes, theap, tstats, tbase = TP._rand_arrays(3, n_pad=n, c_pad=c_pad)
    assert tbase == base
    assert np.array_equal(codes, np.asarray(u8))
    assert np.array_equal(theap, np.asarray(heap))
    assert np.array_equal(tstats, np.asarray(stats))
    want = JP._route_tables(np.random.default_rng(5), L, n_bins, b_val,
                            c_pad)
    got = TP._route_arrays(np.random.default_rng(5), L, n_bins, b_val,
                           c_pad)
    for a, b in zip(got, want):
        assert np.array_equal(a, np.asarray(b))
    # the plain versions the gate holds the kernels against = the JAX
    # package's XLA twins on these inputs
    tbl, route_cat, route_num = got
    for route_f in (route_cat, route_num):
        kw = dict(base=base, L=L, any_cat=route_f is route_cat,
                  na_code=b_val)
        h_x, _ = JHP.sbh_route_xla(u8, heap, jnp.asarray(tbl),
                                   jnp.asarray(route_f), **kw)
        h_t, _ = HC.sbh_route_plain(*(torch.from_numpy(a) for a in (
            codes, theap, tbl, route_f)), base=base, L=L)
        assert np.array_equal(h_t.numpy(), np.asarray(h_x))
    si = TP._int8_arrays(4, tstats.shape)
    for half in (False, True):
        kw = dict(base=base, L=L, n_bins=n_bins, half=half)
        l_eff = (L + 1) // 2 if half else L
        hx = np.asarray(JHP.sbh_hist_xla(u8, heap, stats, **kw))
        ht = HC.sbh_hist_plain(torch.from_numpy(codes),
                               torch.from_numpy(theap),
                               torch.from_numpy(tstats), **kw)
        ht = ht[:l_eff, :c_pad].numpy()
        for s in range(3):
            scale = np.abs(hx[:l_eff, :, s]).max()
            assert np.abs(ht[:, :, s] - hx[:l_eff, :, s]).max() \
                <= 1e-5 * scale
        ix = np.asarray(JHP.sbh_hist_xla(u8, heap, jnp.asarray(si), **kw))
        it = HC.sbh_hist_plain(torch.from_numpy(codes),
                               torch.from_numpy(theap),
                               torch.from_numpy(si), **kw)
        # stat row 3: summed by the JAX twin, zero in the port's forms
        assert np.array_equal(it[:l_eff, :c_pad, :3].numpy(),
                              ix[:l_eff, :, :3])


def test_kernel_parity_check_raises_on_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA kernels"):
        TP.kernel_parity_check(seed=0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA kernels"):
            TP.kernel_parity_check(seed=0)
