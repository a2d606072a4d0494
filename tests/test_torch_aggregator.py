"""The aggregator of the port against the JAX package's, on the CPU.

The parity frame is a lattice: 3,008 rows of six columns whose values
are symmetric around 0 with a population sd of exactly 1 or 2, trained
with standardize=False, so every normalised value, difference and
squared distance is exact in f32 and both packages see the same
distances bit for bit, ties included (many rows repeat, and many rows lie
equally far from two exemplars). The fixture asserts that every squared
distance lies more than 1e-4·r² away from r² at every radius the sweeps
use, so a failure names its cause. Tolerances: the same exemplar rows,
counts, and the radius within 1e-6 relative (the JAX package takes the
diameter's norm in f32, the port in float64). The batched admission equals the
plain row-by-row walk exactly (the same distances) at batch sizes 1, 7
and 4096 on a continuous frame.
"""

import numpy as np
import pytest
import torch

import h2o3_tpu.models as JMODELS
import h2o3_tpu_torch
from h2o3_tpu.core.frame import Frame as JFrame
from h2o3_tpu.models import aggregator as JAGG
from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models import aggregator as TAGG

N = 3008


@pytest.fixture(scope="module")
def port_cpu():
    h2o3_tpu_torch.init(device="cpu")
    yield
    h2o3_tpu_torch.shutdown()


def _lattice(seed=51):
    """Columns of exact multisets: +-1 half each (sd 1); -2, 0, 2 at 1/8,
    3/4, 1/8 (sd 1); -3, -1, 1, 3 at 3/16, 5/16, 5/16, 3/16 (sd 2)."""
    rng = np.random.default_rng(seed)
    kinds = ([-1] * 8 + [1] * 8, [-2] * 2 + [0] * 12 + [2] * 2,
             [-3] * 3 + [-1] * 5 + [1] * 5 + [3] * 3)
    cols = {}
    for j, kind in enumerate(kinds * 2):
        cols[f"c{j}"] = rng.permutation(np.tile(kind, N // 16)).astype(float)
    return cols


@pytest.fixture(scope="module")
def lattice(port_cpu):
    cols = _lattice()
    radii = []
    sweep = JAGG.H2OAggregatorEstimator._sweep

    def recording(X, radius):
        radii.append(radius)
        return sweep(X, radius)
    params = dict(target_num_exemplars=60, rel_tol_num_exemplars=0.5,
                  standardize=False)
    JAGG.H2OAggregatorEstimator._sweep = staticmethod(recording)
    try:
        jm = JMODELS.H2OAggregatorEstimator(**params)
        jm.train(training_frame=JFrame.from_dict(cols))
    finally:
        JAGG.H2OAggregatorEstimator._sweep = staticmethod(sweep)
    tm = h2o3_tpu_torch.H2OAggregatorEstimator(**params)
    tm.train(training_frame=Frame.from_dict(cols))
    X = tm._normalized(Frame.from_dict(cols))
    d2 = TAGG._sqdist(X, X).double()
    for r in radii:
        gap = float((d2 - r * r).abs().min())
        assert gap > 1e-4 * r * r, f"a distance lies at r² ({r}): {gap}"
    return jm, tm, radii


def test_aggregator_exemplars_match_jax(lattice):
    """The same exemplar rows and counts as the JAX package's sweeps, at
    the same radius; the counts sum to the rows; ties among equidistant
    exemplars go to the earliest in both."""
    jm, tm, radii = lattice
    assert len(radii) >= 2          # the radius was retuned at least once
    np.testing.assert_array_equal(tm._exemplar_rows.numpy(),
                                  jm._exemplar_rows)
    agg = tm.aggregated_frame()
    jagg = JMODELS.H2OAggregatorEstimator.aggregated_frame(jm)
    np.testing.assert_array_equal(agg.vec("counts").to_numpy(),
                                  jagg.vec("counts").to_numpy()[:agg.nrows])
    assert int(tm._counts.sum()) == N
    assert tm.summary()["num_exemplars"] == jm._output.model_summary[
        "num_exemplars"]
    assert tm.summary()["radius"] == pytest.approx(
        jm._output.model_summary["radius"], rel=1e-6)
    assert agg.names == [f"c{j}" for j in range(6)] + ["counts"]


def _continuous(n=1500, seed=52):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    X[n // 2:] *= 0.3                   # a dense half: many covered rows
    return torch.from_numpy(X)


@pytest.mark.parametrize("batch", [1, 7, 4096])
def test_batched_admission_equals_plain_walk(batch):
    """`_sweep` at batch sizes 1, 7 and 4096 gives the plain row-by-row
    walk's exemplars and counts exactly, at a radius that makes many
    in-batch candidates and one that makes few."""
    X = _continuous()
    for radius in (0.9, 2.0):
        ex, cnt = TAGG._sweep(X, radius, batch=batch)
        pex, pcnt = TAGG._sweep_plain(X, radius)
        torch.testing.assert_close(ex, pex, rtol=0, atol=0)
        torch.testing.assert_close(cnt, pcnt, rtol=0, atol=0)
        assert int(cnt.sum()) == X.shape[0]


def test_leader_rounds_follow_row_order():
    """The candidates' leader set: a chain a~b~c leads a and c; a row near
    two earlier leaders drops out."""
    close = torch.zeros((5, 5), dtype=torch.bool)
    for i, j in ((0, 1), (1, 2), (3, 0), (3, 2)):
        close[i, j] = close[j, i] = True
    close |= torch.eye(5, dtype=torch.bool)
    assert TAGG._leaders(close).tolist() == [True, False, True, False, True]


def test_aggregator_transform_is_refused(port_cpu):
    """transform other than NORMALIZE raises: the JAX package always
    divides by the sd."""
    f = Frame.from_dict(_lattice())
    with pytest.raises(NotImplementedError, match="transform"):
        h2o3_tpu_torch.H2OAggregatorEstimator(transform="NONE").train(
            training_frame=f)
