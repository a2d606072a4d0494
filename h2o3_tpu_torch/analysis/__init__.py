"""Analysis of the port (h2o3_tpu/analysis/): a static analyzer over
`h2o3_tpu_torch/` and the port's tests, and the runtime checkers.

The static analyzer (engine, cfg, callgraph, effects, lifecycle, the
rules_* modules, sarif) imports only the standard library. It keeps the
reference's rule ids, `# h2o3-ok: R00n reason` waivers, baseline format
and censuses; five ids take the port's meaning:

  R001 a program built per call  torch.cuda.CUDAGraph()/graph(...)
                         outside serving/scorer_cache.py, torch.compile
                         inside a function body, ctypes.CDLL outside
                         ops/_build.py
  R002 host sync         .item()/.tolist()/.cpu()/.numpy(), a
                         synchronize(), float/int/bool or np.asarray of
                         a torch expression, a host-to-device copy — in
                         the capture scope (the `_score_with_params` /
                         `_score_matrix` family and a graph capture's
                         body), or a barrier inside a timeline.span block
  R004 impure under capture  time.*/random.*/global rebinding/
                         torch.rand* without generator= in the capture
                         scope: run once at capture, repeated by replays
  R014 unguarded collective  a torch.distributed collective outside
                         parallel/compat.py's guards (gloo pairs the
                         ranks' collectives by their order)
  R025 capture contract  the scorer family and what it reaches: no
                         module-level tensor captured by closure, no
                         `if x:`/float(x)/bool(x) on a tensor argument

R003 and R005-R024 are the reference's rules over the port's paths, with
the torch syncs in R008/R015. `python -m h2o3_tpu_torch.analysis` runs
it (`--write-census` writes obs/METRICS.md, obs/SPANS.md,
analysis/ENV.md and deploy/PROTOCOL.md; `--check-census` gates them).

The runtime checkers: the lock-order checker `lockdep`, the replay
divergence sanitizer `divergence`, the lifecycle tracker `leaktrack`
and the sanitizers (`sanitizers`).
"""
