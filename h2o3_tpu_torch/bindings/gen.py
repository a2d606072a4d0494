"""Python client-bindings generator — h2o-bindings/bin/gen_python.py analog.

The reference generates its h2o-py estimator classes from the server's live
schema metadata (water/api/SchemaServer.java serves it; gen_python.py writes
h2o-py/h2o/estimators/*.py). Same flow here: point `gen_python` at a running
REST server (the port's, `python -m h2o3_tpu_torch`, or the JAX package's);
it reads /3/ModelBuilders (algo list), per-algo parameter schemas from
/3/ModelBuilders/{algo}, and /3/Metadata/endpoints, then writes a
self-contained `estimators.py` whose classes talk to the server purely over
HTTP: it imports only the standard library. The text is the JAX package's
generator's but for the generator's name in its first line.
"""

from __future__ import annotations

import json
import os
import urllib.request

_RUNTIME = '''"""GENERATED by h2o3_tpu_torch.bindings.gen — do not edit.

Self-contained REST estimator clients for a running h2o3-tpu server.
"""

import json
import time
import urllib.parse
import urllib.request

# repr() of parameter defaults may reference these (e.g. max_w2=inf)
inf = float("inf")
nan = float("nan")


class H2OConnection:
    """Minimal REST connection (h2o-py backend/connection.py analog)."""

    def __init__(self, url):
        self.url = url.rstrip("/")

    def get(self, path, **params):
        q = urllib.parse.urlencode(params)
        with urllib.request.urlopen(f"{self.url}{path}?{q}") as r:
            return json.loads(r.read())

    def post(self, path, **params):
        body = urllib.parse.urlencode(params).encode()
        req = urllib.request.Request(f"{self.url}{path}", data=body)
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read())

    def wait_job(self, key, timeout=600.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            j = self.get(f"/3/Jobs/{key}")["jobs"][0]
            if j["status"] in ("DONE", "FAILED", "CANCELLED"):
                return j
            time.sleep(0.2)
        raise TimeoutError(f"job {key} timed out")


class _GeneratedEstimator:
    algo = None

    def __init__(self, connection, **params):
        self._conn = connection
        unknown = set(params) - set(self.param_names) - {
            "model_id", "seed", "nfolds"}
        if unknown:
            raise TypeError(f"unknown {self.algo} parameters: "
                            f"{sorted(unknown)}")
        self.params = params
        self.key = None

    def train(self, y=None, training_frame=None, **kw):
        p = dict(self.params)
        p.update(kw)
        p["training_frame"] = training_frame
        if y is not None:
            p["response_column"] = y
        r = self._conn.post(f"/3/ModelBuilders/{self.algo}", **p)
        j = self._conn.wait_job(r["job"]["key"]["name"]
                                if isinstance(r["job"]["key"], dict)
                                else r["job"]["key"])
        if j["status"] != "DONE":
            raise RuntimeError(f"build failed: {j}")
        self.key = j.get("dest") or p.get("model_id")
        return self

    def predict(self, frame_key, predictions_frame=None):
        dest = predictions_frame or f"{self.key}_preds"
        self._conn.post(
            f"/3/Predictions/models/{self.key}/frames/{frame_key}",
            predictions_frame=dest)
        return dest

    def model(self):
        return self._conn.get(f"/3/Models/{self.key}")["models"][0]

    def metrics(self):
        return self.model().get("training_metrics") or {}
'''

_CLASS_TMPL = '''

class {cls_name}(_GeneratedEstimator):
    """{algo} estimator (generated from /3/ModelBuilders/{algo}).

    Parameters ({n_params}): {param_preview}
    """
    algo = "{algo}"
    param_names = {param_names}
    param_defaults = {param_defaults}
'''


def _fetch(url, path):
    with urllib.request.urlopen(url.rstrip("/") + path) as r:
        return json.loads(r.read())


def _cls_name(algo: str) -> str:
    special = {
        "gbm": "H2OGradientBoostingEstimator",
        "drf": "H2ORandomForestEstimator",
        "glm": "H2OGeneralizedLinearEstimator",
        "kmeans": "H2OKMeansEstimator",
        "deeplearning": "H2ODeepLearningEstimator",
        "xgboost": "H2OXGBoostEstimator",
        "pca": "H2OPrincipalComponentAnalysisEstimator",
        "naivebayes": "H2ONaiveBayesEstimator",
        "isolationforest": "H2OIsolationForestEstimator",
    }
    return special.get(algo, "H2O" + algo.capitalize() + "Estimator")


def gen_python(server_url: str, out_dir: str) -> list:
    """Generate REST estimator classes for every algo the server exposes.
    Returns the list of generated class names."""
    os.makedirs(out_dir, exist_ok=True)
    builders = _fetch(server_url, "/3/ModelBuilders")["model_builders"]
    endpoints = _fetch(server_url, "/3/Metadata/endpoints")
    parts = [_RUNTIME]
    names = []
    for algo in sorted(builders):
        try:
            info = _fetch(server_url, f"/3/ModelBuilders/{algo}")
            params = info["model_builders"][algo].get("parameters", [])
        except Exception:
            params = []
        pnames = [p["name"] for p in params]
        defaults = {p["name"]: p.get("default_value") for p in params}
        cls = _cls_name(algo)
        names.append(cls)
        parts.append(_CLASS_TMPL.format(
            cls_name=cls, algo=algo, n_params=len(pnames),
            param_preview=", ".join(pnames[:8]) + ("…" if len(pnames) > 8
                                                   else ""),
            param_names=repr(pnames),
            param_defaults=repr(defaults)))
    parts.append(f"\n\nALL_ESTIMATORS = {names!r}\n"
                 f"NUM_SERVER_ROUTES = {endpoints.get('num_routes', 0)}\n")
    with open(os.path.join(out_dir, "estimators.py"), "w") as f:
        f.write("".join(parts))
    with open(os.path.join(out_dir, "__init__.py"), "w") as f:
        f.write("from .estimators import *  # noqa: F401,F403\n")
    return names
