"""In-product self-benchmarks: water/init/{NetworkBench,Linpack,
MemoryBandwidth}.java on the cloud's device.

Reference: NetworkBench.java (message latency and throughput across the
cloud), Linpack.java (FLOPS a node), MemoryBandwidth.java (memory
bandwidth a node), used to sanity-check a node before long jobs.

On one CUDA card:
- the "network" has no collective: `network_bench` times a sum reduction
  of each payload on the device (`"collective": "none"`, as
  /3/NetworkTest answers), its read rate as the bandwidth;
- `linpack` is a `torch.matmul` probe, f32 with TF32 off (stated in the
  result) and bf16 accumulating in f32;
- `memory_bandwidth` is the stream triad a = b + 2·c as one torch call
  (`torch.add(b, c, alpha=2.0)`: one kernel), 12 bytes an element (two
  f32 reads, one write).

Times come from CUDA events after a warm-up call (the host clock on a CPU
cloud). CLI: `python -m h2o3_tpu_torch.utils.selfbench`."""

from __future__ import annotations

import time

import torch


def _device():
    from h2o3_tpu_torch.parallel import mesh as MESH
    return MESH.cloud().device


def _timeit(fn, dev, repeats=5):
    """Seconds a call of fn(), after one warm-up call."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    return (time.perf_counter() - t0) / repeats


def device_reduce_seconds(nbytes: int, dev=None, repeats=5) -> float:
    """Seconds of one sum reduction of `nbytes` of f32 ones on `dev`."""
    dev = _device() if dev is None else torch.device(dev)
    x = torch.ones(max(nbytes // 4, 1), dtype=torch.float32, device=dev)
    return _timeit(x.sum, dev, repeats)


def network_bench(sizes=(1 << 10, 1 << 16, 1 << 22), repeats=5) -> list:
    """A device reduction a payload size. One card has no collective to
    time: `collective` says "none", `algo_bw_gbps` is the payload read
    over the reduction's time."""
    dev = _device()
    results = []
    for size in sizes:
        n = max(size // 4, 1)
        dt = device_reduce_seconds(size, dev, repeats)
        results.append({
            "op": "device_reduce", "collective": "none",
            "payload_bytes_per_device": int(n * 4),
            "latency_us": dt * 1e6,
            "algo_bw_gbps": n * 4 / max(dt, 1e-12) / 1e9,
        })
    return results


def linpack(n: int = 4096, dtype="bfloat16", repeats=10) -> dict:
    """C = A @ B throughput (Linpack.java analog). float32 runs with TF32
    off for the call (`tf32` False in the result); bfloat16 accumulates in
    f32 on the card."""
    dev = _device()
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    a = torch.ones((n, n), dtype=dt, device=dev)
    b = torch.ones((n, n), dtype=dt, device=dev)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = _timeit(lambda: torch.matmul(a, b), dev, repeats)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    flops = 2.0 * n * n * n
    return {"n": n, "dtype": dtype, "tf32": False, "seconds": t,
            "gflops": flops / max(t, 1e-12) / 1e9}


def memory_bandwidth(n: int = 1 << 24, repeats=10) -> dict:
    """The stream triad a = b + 2·c (MemoryBandwidth.java analog): 12
    bytes an element."""
    dev = _device()
    b = torch.ones(n, dtype=torch.float32, device=dev)
    c = torch.ones(n, dtype=torch.float32, device=dev)
    t = _timeit(lambda: torch.add(b, c, alpha=2.0), dev, repeats)
    return {"elements": n, "seconds": t,
            "gbps": n * 4 * 3 / max(t, 1e-12) / 1e9}


def publish(results: dict) -> dict:
    """Set the `h2o3_selfbench` gauge (the JAX package's series and
    labels) so /metrics reports the same hardware facts; the network
    probes keep their `ici_*` names and carry the device reduction."""
    from h2o3_tpu_torch.obs import metrics as om
    g = om.gauge("h2o3_selfbench", "in-product hardware self-benchmarks "
                 "(linpack gflops, HBM triad GB/s, ICI collectives)")
    for key in ("linpack", "linpack_f32"):
        lp = results.get(key)
        if lp:
            g.set(lp["gflops"], probe="linpack_gflops", dtype=lp["dtype"],
                  payload_bytes="")
    mb = results.get("memory_bandwidth")
    if mb:
        g.set(mb["gbps"], probe="hbm_triad_gbps", dtype="",
              payload_bytes="")
    for row in results.get("network") or []:
        pb = str(row["payload_bytes_per_device"])
        g.set(row["latency_us"], probe="ici_latency_us", dtype="",
              payload_bytes=pb)
        g.set(row["algo_bw_gbps"], probe="ici_bw_gbps", dtype="",
              payload_bytes=pb)
    return results


def run_all(linpack_n: int = 4096, triad_n: int = 1 << 24) -> dict:
    """Every probe on the cloud's device, published; the JAX package's
    keys, with `linpack_f32` beside the bf16 `linpack`."""
    from h2o3_tpu_torch.parallel import mesh as MESH
    cl = MESH.cloud()
    return publish({"network": network_bench(),
                    "linpack": linpack(linpack_n),
                    "linpack_f32": linpack(linpack_n, "float32"),
                    "memory_bandwidth": memory_bandwidth(triad_n),
                    "backend": cl.device.type,
                    "n_devices": cl.n_devices})


if __name__ == "__main__":
    import json
    import h2o3_tpu_torch
    h2o3_tpu_torch.init()
    print(json.dumps(run_all(), indent=2, default=float))
