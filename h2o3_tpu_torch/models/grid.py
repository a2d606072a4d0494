"""Grid search of the port (h2o3_tpu/models/grid.py,
hex/grid/GridSearch.java with HyperSpaceWalker.java).

Cartesian search walks every combination of the hyper-parameters in the
order of their sorted names; RandomDiscrete shuffles that list with
numpy's default_rng(seed), as the JAX package draws it, and keeps the
first `max_models`. `search_criteria["max_runtime_secs"]` stops launching
models once it has passed. A model that fails to train is recorded in
`failures` with its combination and error, and the grid goes on. Model ids
are `{grid_id}_model_{i}`, i the combination's place in the walk.

`parallelism` is accepted as in the JAX package, and every value walks
the combinations one after another: the trains of one process share one
card's stream and the kernels' launch counters, so trains from threads
would overlap only host work, and one walk keeps every model bit for bit
what it is when trained alone. The JAX package serialises trains on host
meshes too (its `train_guard`).

With `recovery_dir` (hex/faulttolerance/Recovery.java), the training and
validation frames and every finished model are checkpointed there
(io/persist.py `Recovery`); a grid trained again with the same `grid_id`
and directory loads the models a previous run finished and skips their
combinations. A RandomDiscrete walk without a seed then takes its seed
from the grid id, so the walk is the same after the restart.
"""

from __future__ import annotations

import itertools
import time
import zlib

import numpy as np

from h2o3_tpu_torch.core.kvstore import DKV


class H2OGridSearch:
    def __init__(self, model, hyper_params: dict, grid_id=None,
                 search_criteria=None, parallelism: int = 1,
                 recovery_dir: str | None = None):
        # an estimator class, or an instance whose parameters are defaults
        if isinstance(model, type):
            self._cls = model
            self._base_params = {}
        else:
            self._cls = model.__class__
            self._base_params = {k: v for k, v in model.params.items()
                                 if v is not None}
        self.hyper_params = hyper_params
        self.grid_id = grid_id or DKV.make_key("grid")
        self.search_criteria = dict(search_criteria
                                    or {"strategy": "Cartesian"})
        self.models: list = []
        self.failures: list = []
        self.parallelism = max(1, int(parallelism))
        self.recovery_dir = recovery_dir
        DKV.put(self.grid_id, self)

    def _combos(self) -> list:
        keys = sorted(self.hyper_params)
        combos = [dict(zip(keys, c)) for c in
                  itertools.product(*(self.hyper_params[k] for k in keys))]
        if self.search_criteria.get("strategy",
                                    "Cartesian") == "RandomDiscrete":
            seed = int(self.search_criteria.get("seed", -1))
            if seed <= 0 and self.recovery_dir:
                # recovery skips combinations by index: the walk must be
                # the same after a restart
                seed = zlib.crc32(self.grid_id.encode()) or 1
            rng = np.random.default_rng(seed if seed > 0 else None)
            rng.shuffle(combos)
            mx = self.search_criteria.get("max_models")
            if mx:
                combos = combos[:int(mx)]
        return combos

    def train(self, x=None, y=None, training_frame=None,
              validation_frame=None, **kw):
        max_secs = float(self.search_criteria.get("max_runtime_secs", 0)
                         or 0)
        t0 = time.time()
        recovery, recovered = None, set()
        if self.recovery_dir:
            from h2o3_tpu_torch.io.persist import Recovery
            recovery = Recovery(self.recovery_dir)
            recovery.resume()
            # only this grid's models: the directory may hold others'
            prefix = f"{self.grid_id}_model_"
            recovered = {k for k in recovery.recovered_model_keys()
                         if k.startswith(prefix)}
            have = {m.key for m in self.models}
            for key in sorted(recovered - have):
                prev = DKV.get(key)
                if prev is not None:
                    self.models.append(prev)
            for fr in (training_frame, validation_frame):
                if fr is not None:
                    recovery.checkpoint_frame(fr)
        for i, combo in enumerate(self._combos()):
            if max_secs and time.time() - t0 > max_secs:
                break
            if f"{self.grid_id}_model_{i}" in recovered:
                continue                   # finished before the restart
            params = dict(self._base_params)
            params.update(kw)
            params.update(combo)
            params["model_id"] = f"{self.grid_id}_model_{i}"
            try:
                m = self._cls(**params)
                m.train(x=x, y=y, training_frame=training_frame,
                        validation_frame=validation_frame)
                self.models.append(m)
                if recovery is not None:
                    recovery.checkpoint_model(m)
            except Exception as ex:  # noqa: BLE001 - the grid goes on
                self.failures.append({"params": combo, "error": repr(ex)})
        return self

    def get_grid(self, sort_by: str = "auc", decreasing=None) -> list:
        """The models sorted by a metric of their cross-validation,
        validation or training metrics, in that order of preference."""
        if decreasing is None:
            decreasing = sort_by in ("auc", "pr_auc", "r2", "accuracy", "f1")

        def metric(m):
            src = (m._output.cross_validation_metrics
                   or m._output.validation_metrics
                   or m._output.training_metrics)
            v = getattr(src, sort_by, None)
            return v if v is not None else float("inf")

        return sorted(self.models, key=metric, reverse=decreasing)

    @property
    def model_ids(self):
        return [m.key for m in self.models]

    def __len__(self):
        return len(self.models)
