"""`python -m h2o3_tpu_torch` — the `java -jar h2o.jar` analog (port of
h2o3_tpu/__main__.py).

Parses the OptArgs-style CLI (water/H2O.java:327: -port, -name, -ip,
-basic_auth/-hash_login file, -ssl, …), forms the cloud on the card (one
process, or a world of several through deploy/multihost when
H2O3_COORDINATOR_ADDRESS is set: rank 0 serves REST + Flow and replays
each request to the others) and serves until interrupted. Without a card
`init()` raises; H2O3_DEVICE=cpu asks for the CPU (the options are the
JAX package's). H2O3_JOIN_CLOUD=1 starts a replacement worker instead:
it joins the replay channel of the running cloud whose coordinator
serves REST on -port at H2O3_COORDINATOR_ADDRESS's host, as worker
H2O3_PROCESS_ID (deploy/multihost.join_cloud). `-n_model_shards` other
than 1 raises ValueError: the port has no model axis."""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="h2o3-tpu-torch",
        description="Start an h2o3-tpu-torch node (REST + Flow on one "
                    "host, on its first CUDA card)")
    ap.add_argument("-port", "--port", type=int, default=54321)
    ap.add_argument("-ip", "--ip", default=None,
                    help="bind address (default loopback; 0.0.0.0 when "
                         "-bind_all)")
    ap.add_argument("-name", "--name", default=None,
                    help="cloud name (water.H2O -name)")
    ap.add_argument("-bind_all", action="store_true",
                    help="listen on every interface (requires auth or "
                         "H2O3_INSECURE_BIND_ALL=1)")
    ap.add_argument("-basic_auth", "--auth_file", default=None,
                    help="user:password lines file (-hash_login analog)")
    ap.add_argument("-ssl_cert", default=None)
    ap.add_argument("-ssl_key", default=None)
    ap.add_argument("-n_rows_shards", type=int, default=None,
                    help="row shards: the world's size (one a process)")
    ap.add_argument("-n_model_shards", type=int, default=1)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from h2o3_tpu_torch.utils import config as _cfg
    if args.n_model_shards != 1:
        raise ValueError("the port's cloud has no model axis: "
                         "-n_model_shards must be 1")
    if args.name:
        _cfg.set_property("cloud.name", args.name)
    if args.bind_all:
        _cfg.set_property("api.bind_all", True)
    if args.auth_file:
        _cfg.set_property("api.auth_file", args.auth_file)
    if args.ssl_cert:
        _cfg.set_property("api.ssl_cert", args.ssl_cert)
    if args.ssl_key:
        _cfg.set_property("api.ssl_key", args.ssl_key)

    from h2o3_tpu_torch.deploy import multihost
    from h2o3_tpu_torch.utils.env import env_bool, env_str, process_id
    device = env_str("H2O3_DEVICE", "") or None
    if env_bool("H2O3_JOIN_CLOUD", False):
        host = multihost._coordinator_address().rpartition(":")[0]
        multihost.join_cloud(host or "127.0.0.1", args.port, process_id(),
                             device=device)
        return 0
    if multihost.is_multihost():
        multihost.serve(args.port, n_rows_shards=args.n_rows_shards,
                        n_model_shards=args.n_model_shards, device=device,
                        host=args.ip)
        return 0
    if (args.n_rows_shards or 1) != 1:
        raise ValueError("a cloud of one process on one device holds one "
                         "row shard: -n_rows_shards needs "
                         "H2O3_COORDINATOR_ADDRESS")
    import h2o3_tpu_torch
    cloud = h2o3_tpu_torch.init(device)
    from h2o3_tpu_torch.api.server import H2OServer
    srv = H2OServer(args.port, host=args.ip)
    print(f"h2o3-tpu-torch cloud up: {cloud.n_devices} device "
          f"({h2o3_tpu_torch.cluster_info()['devices'][0]}); "
          f"REST + Flow on :{srv.port}")
    try:
        srv.start(background=False)
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
