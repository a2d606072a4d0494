"""The port's usage attribution and pressure model (obs/usage.py) against
the JAX package's, on the CPU. Mirrors tests/test_usage.py where its
cases need no REST server.

- the meter: the outermost meter owns the charge (principal, model,
  kind, rows, calls as in the JAX ledger for the same script; the
  seconds are wall time, so only their presence is compared); charges
  of explicit seconds give the SAME ledger in both packages, the
  principal fold (QoS `_overflow`) and the model fold (`_other`)
  included — exact, the same float additions;
- the stage recorder: the remainder folds into `app`, the Server-Timing
  header is the JAX one character for character, a capture takes
  precedence over the request recorder and merges into it;
- the device rate under sustained charging, the switch off (free);
- two tenants scoring concurrently through `score_payload` split the
  ledger by rows, and the ledger sums to the total (1e-6);
- `evaluate_pressure`: all seven dimensions, the queue dimension from a
  tenant at its share, the tier dimensions from the pager's "hbm" key;
  the cluster merges of usage and pressure documents equal the JAX
  package's on the same documents;
- `forget_model` drops the model's ledger rows and series once.
"""

import threading
import time

import numpy as np
import pytest

import h2o3_tpu_torch
from h2o3_tpu.obs import tracing as JTR
from h2o3_tpu.obs import usage as JU
from h2o3_tpu.serving import qos as JQ
from h2o3_tpu_torch import serving
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.obs import tracing, usage
from h2o3_tpu_torch.serving import microbatch as mb
from h2o3_tpu_torch.serving import qos

ROW = [{"a": 0.1, "b": 0.2}]
PKGS = {"jax": (JU, JQ, JTR), "port": (usage, qos, tracing)}


@pytest.fixture(autouse=True)
def _fresh():
    for U, Q, _ in PKGS.values():
        Q.reset()
        U.reset()
    yield
    for U, Q, _ in PKGS.values():
        U.set_enabled(None)
        Q.reset()
        U.reset()


@pytest.fixture(scope="module")
def glm_model():
    h2o3_tpu_torch.init(device="cpu")
    rng = np.random.default_rng(16)
    fr = Frame.from_dict({"a": rng.normal(size=240),
                          "b": rng.normal(size=240),
                          "resp": rng.choice(["no", "yes"], size=240)})
    m = h2o3_tpu_torch.H2OGeneralizedLinearEstimator(family="binomial")
    m.train(x=["a", "b"], y="resp", training_frame=fr)
    yield m
    DKV.remove(fr.key)
    DKV.remove(m.key)
    h2o3_tpu_torch.shutdown()


def _ledger(U, with_seconds=True):
    rows = U.usage_snapshot()["ledger"]
    keep = ("principal", "model", "kind", "calls", "rows") + \
        (("device_seconds",) if with_seconds else ())
    return [{k: r[k] for k in keep} for r in rows]


# ---------------------------------------------------------------------------
def test_meter_charges_the_outermost_as_jax():
    got = {}
    for name, (U, Q, TR) in PKGS.items():
        with TR.request_context("alice"):
            with U.meter("score", model="m_test", rows=4):
                with U.meter("jit"):
                    time.sleep(0.01)
        with U.meter("jit"):
            pass
        snap = U.usage_snapshot()
        assert snap["ledger"][0]["device_seconds"] >= 0.01
        got[name] = _ledger(U, with_seconds=False)
    assert got["port"] == got["jax"]
    assert {r["principal"] for r in got["port"]} == {"alice", "anonymous"}


def _charge_script(U, Q):
    rng = np.random.default_rng(4)
    for i in range(40):
        U.charge("score" if i % 3 else "train",
                 float(rng.integers(1, 1000)) / 1024.0,
                 model=f"model_{i % 7}", rows=int(rng.integers(1, 64)),
                 principal=f"tenant_{i % 5}")


def test_charges_and_folds_equal_jax(monkeypatch):
    monkeypatch.setenv("H2O3_QOS_MAX_PRINCIPALS", "3")
    monkeypatch.setenv("H2O3_USAGE_MAX_MODELS", "4")
    got = {}
    for name, (U, Q, _) in PKGS.items():
        Q.reset()
        _charge_script(U, Q)
        snap = U.usage_snapshot()
        got[name] = (_ledger(U), snap["device_seconds_total"],
                     U.device_seconds_total())
    assert got["port"] == got["jax"]
    principals = {r["principal"] for r in got["port"][0]}
    models = {r["model"] for r in got["port"][0]}
    assert qos.OVERFLOW in principals and len(principals) == 4
    assert usage.OTHER_MODEL in models and len(models) == 5


def test_device_rate_and_switch():
    t_end = time.monotonic() + 0.2
    while time.monotonic() < t_end:
        usage.charge("score", 0.001)
        time.sleep(0.002)
    assert usage.device_rate(window_s=1.0) > 0.0
    usage.reset()
    usage.set_enabled(False)
    with usage.meter("score", model="m", rows=1):
        time.sleep(0.001)
    usage.begin_request()
    with usage.stage("decode"):
        pass
    assert usage.finish_request(0.5) is None
    assert usage.device_seconds_total() == 0.0
    assert usage.usage_snapshot()["ledger"] == []


def test_stage_recorder_and_server_timing_equal_jax():
    got = {}
    for name, (U, _, _) in PKGS.items():
        U.begin_request()
        U.add_stage("decode", 0.010)
        with U.capture_stages() as cap:
            U.add_stage("device", 0.030)    # into the capture only
            U.add_stage("readback", 0.002)
        U.merge_stages(dict(cap, queue=0.001))
        st = U.finish_request(wall=0.050)
        got[name] = (st, U.server_timing(st), dict(cap))
    assert got["port"] == got["jax"]
    st, hdr, cap = got["port"]
    assert cap == {"device": 0.030, "readback": 0.002}
    assert st["app"] == pytest.approx(0.007)
    assert hdr == ("queue;dur=1.000, decode;dur=10.000, device;dur=30.000, "
                   "readback;dur=2.000, app;dur=7.000")


def test_two_tenants_split_by_rows(glm_model):
    serving.score_payload(glm_model, ROW)       # warm
    usage.reset()

    def run(principal, n):
        with tracing.request_context(principal):
            for _ in range(n):
                serving.score_payload(glm_model, ROW)

    ts = [threading.Thread(target=run, args=("alice", 24)),
          threading.Thread(target=run, args=("bob", 8))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    per_rows, per_s = {}, {}
    snap = usage.usage_snapshot()
    for r in snap["ledger"]:
        if r["kind"] == "score":
            per_rows[r["principal"]] = per_rows.get(r["principal"], 0) \
                + r["rows"]
            per_s[r["principal"]] = per_s.get(r["principal"], 0.0) \
                + r["device_seconds"]
    assert per_rows == {"alice": 24, "bob": 8}
    assert per_s["alice"] > 0.0 and per_s["bob"] > 0.0
    assert sum(r["device_seconds"] for r in snap["ledger"]) == \
        pytest.approx(usage.device_seconds_total(), abs=1e-6)


# ---------------------------------------------------------------------------
DIMS = {"queue", "utilization", "slo_burn", "tier_occupancy",
        "tier_faults", "stalls", "drift"}


def test_pressure_has_every_dimension(monkeypatch, glm_model):
    from h2o3_tpu_torch.core import tiering
    doc = usage.evaluate_pressure()
    assert set(doc["dimensions"]) == DIMS
    assert doc["overall"] == max(doc["dimensions"].values())
    assert usage.last_pressure() is doc
    series = {lbl["dimension"]: v for lbl, v in usage._pressure_series()}
    assert set(series) == DIMS | {"overall"}
    # the tier dimension reads the pager's "hbm" key against its budget
    monkeypatch.setattr(tiering.PAGER, "hbm_budget", 1000)
    monkeypatch.setattr(tiering.PAGER, "tier_bytes",
                        lambda: {"hbm": 250, "host": 0, "disk": 0})
    assert usage.evaluate_pressure()["dimensions"]["tier_occupancy"] == 0.25


def test_pressure_queue_dimension_direct(monkeypatch):
    limit = mb._queue_depth_limit()
    share = qos.tenant_share_cap(limit)
    monkeypatch.setattr(mb.BATCHER, "_depth", 2)
    monkeypatch.setattr(mb.BATCHER, "_queued", {"flood": share})
    doc = usage.evaluate_pressure()
    assert doc["dimensions"]["queue"] >= 0.99
    assert doc["detail"]["queue"]["by_principal"] == {"flood": share}
    monkeypatch.setattr(mb.BATCHER, "_queued", {})
    monkeypatch.setattr(mb.BATCHER, "_depth", limit)
    assert usage.evaluate_pressure()["dimensions"]["queue"] >= 0.99


def test_cluster_merges_equal_jax():
    docs = [{"host": h, "epoch": 1 + h, "overall": 0.1 * h,
             "dimensions": {"queue": 0.1 * h, "drift": 0.3 - 0.1 * h,
                            "stalls": float(h == 2)}, "detail": {}}
            for h in range(3)]
    assert usage.merge_cloudhealth(docs) == JU.merge_cloudhealth(docs)
    snaps = []
    for h in range(3):
        usage.reset()
        usage.charge("score", 0.25 * (h + 1), model=f"m{h % 2}", rows=h,
                     principal=f"p{h}")
        s = usage.usage_snapshot()
        s["host"] = h
        s["hbm"] = {"params_by_model": {f"m{h % 2}": 100 * h},
                    "params_total_bytes": 100 * h,
                    "params_tier_bytes": {"hbm": 100 * h},
                    "tier": {"faults": h}}
        snaps.append(s)
    assert usage.merge_usage(snaps) == JU.merge_usage(snaps)


def test_forget_model_drops_rows_and_series():
    usage.charge("score", 0.5, model="gone", rows=3, principal="p")
    usage.charge("score", 0.5, model="kept", rows=3, principal="p")
    assert usage.MODEL_DEVICE_SECONDS.value(model="gone", kind="score") \
        == 0.5
    usage.forget_model("gone")
    assert [r["model"] for r in usage.usage_snapshot()["ledger"]] == \
        ["kept"]
    assert not [e for e in usage.MODEL_DEVICE_SECONDS._json()
                if (e["labels"] or {}).get("model") == "gone"]
    usage.forget_model("gone")                      # idempotent
