"""Deployment of the port (h2o3_tpu/deploy/): the chaos layer and the
single-process form of elastic membership. The replay channel, its
elastic broadcaster and the heartbeat (`deploy/multihost.py` and the
rest of `membership.py`) come with the multi-device item (ROADMAP.md
§1)."""
