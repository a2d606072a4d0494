"""bindings/gen.py of the port against the JAX package's, on the CPU: the
JAX `H2OServer(port=0)` and the port's, after
`h2o3_tpu_torch.init(device="cpu")`, in this one process.

- `gen_python` against the port's server writes the file the JAX
  generator writes against the JAX server, byte for byte but the
  generator's module name in the first line (the two servers serve the
  same /3/ModelBuilders and /3/Metadata/endpoints);
- the generated module imports only the standard library;
- a generated `H2OGradientBoostingEstimator` trains over HTTP on a frame
  of the port's store (2,000 seeded numpy rows) and predicts: its trees'
  predictions equal, bit for bit, those of `train()` in process with the
  same keyword arguments; unknown parameters raise TypeError.
"""

import ast
import importlib.util
import json
import urllib.request

import numpy as np
import pytest

import h2o3_tpu
import h2o3_tpu_torch
from h2o3_tpu.api import server as JS
from h2o3_tpu.bindings import gen_python as jax_gen
from h2o3_tpu_torch.api import server as TS
from h2o3_tpu_torch.bindings import gen_python as torch_gen
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV

GBM = dict(ntrees=5, max_depth=4, min_rows=20, seed=7)
STDLIB = {"json", "time", "urllib.parse", "urllib.request"}


@pytest.fixture(scope="module")
def servers():
    h2o3_tpu_torch.init(device="cpu")
    j_before = set(h2o3_tpu.ls())
    t_before = set(DKV.keys())
    js = JS.H2OServer(port=0).start()
    ts = TS.H2OServer(port=0).start()
    rng = np.random.default_rng(21)
    X = rng.normal(0, 1, (2000, 4))
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * rng.normal(size=2000) > 0)
    Frame.from_dict({**{f"x{j}": X[:, j] for j in range(4)},
                     "y": np.array(["no", "yes"], object)[y.astype(int)]},
                    key="bind_train")
    yield (f"http://127.0.0.1:{js.port}", f"http://127.0.0.1:{ts.port}")
    js.stop()
    ts.stop()
    for k in set(DKV.keys()) - t_before:
        DKV.remove(k)
    for k in set(h2o3_tpu.ls()) - j_before:
        h2o3_tpu.remove(k)


@pytest.fixture(scope="module")
def generated(servers, tmp_path_factory):
    jurl, turl = servers
    out = {}
    for tag, gen, url in (("jax", jax_gen, jurl), ("port", torch_gen, turl),
                          ("port_on_jax", torch_gen, jurl)):
        d = tmp_path_factory.mktemp(f"gen_{tag}")
        out[tag] = (gen(url, str(d)), (d / "estimators.py").read_text(), d)
    return out


def test_generated_file_equals_the_jax_servers(generated):
    names_j, text_j, _ = generated["jax"]
    names_t, text_t, _ = generated["port"]
    assert names_t == names_j and len(names_t) == 21
    first, rest = text_t.split("\n", 1)
    assert first == '"""GENERATED by h2o3_tpu_torch.bindings.gen — do not ' \
        'edit.'
    assert text_j.split("\n", 1) == [
        '"""GENERATED by h2o3_tpu.bindings.gen — do not edit.', rest]
    # the port's generator against the JAX server writes the same text
    assert generated["port_on_jax"][1] == text_t


def test_generated_module_imports_only_the_standard_library(generated):
    tree = ast.parse(generated["port"][1])
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    assert mods == STDLIB


def _load(path):
    spec = importlib.util.spec_from_file_location("gen_port_estimators",
                                                  path / "estimators.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_generated_estimator_trains_and_predicts(servers, generated):
    _, turl = servers
    mod = _load(generated["port"][2])
    assert mod.NUM_SERVER_ROUTES >= 120
    conn = mod.H2OConnection(turl)
    est = mod.H2OGradientBoostingEstimator(conn, model_id="bind_gbm", **GBM)
    est.train(y="y", training_frame="bind_train")
    assert est.key == "bind_gbm"
    assert est.metrics().get("AUC", est.metrics().get("auc", 0)) > 0.8
    dest = est.predict("bind_train")
    with urllib.request.urlopen(f"{turl}/3/Frames/{dest}") as r:
        assert json.loads(r.read())["frames"][0]["rows"] == 2000
    fr = DKV.get("bind_train")
    local = h2o3_tpu_torch.H2OGradientBoostingEstimator(**GBM)
    local.train(y="y", training_frame=fr)
    want = local.predict(fr).vec("pyes").as_f32()
    got = DKV.get(dest).vec("pyes").as_f32()
    assert np.array_equal(got.numpy().view(np.uint32),
                          want.numpy().view(np.uint32))
    with pytest.raises(TypeError):
        mod.H2OGradientBoostingEstimator(conn, bogus_param=1)
