"""The cloud and its compute substrate (h2o3_tpu/parallel/): the world of
ranks (`mesh.py`), the MRTask funnel (`mrtask.py`) and the collective
guard (`compat.py`)."""
