"""Deployment of the port (h2o3_tpu/deploy/): the multi-process cloud and
its replay channel (`multihost.py`), elastic membership (`membership.py`)
and the chaos layer (`chaos.py`)."""
