"""The draws of the port's adaptive engine, and their replay of the JAX
package's draws for the parity tests of the engine's estimators.

The port takes every random choice of adaptive growth from
`engine.Draws` (one torch.Generator); the JAX package takes each from a
jax.random key inside its programs. `JaxDraws` hands the port the JAX
package's draws, key for key, so that both grow the same trees: an
estimator's `_draws` is replaced with one. Its `scheme` names the JAX
estimator's key splits (h2o3_tpu/models/tree/*.py):
  tree3  DRF binomial/regression and the isolation forest: per tree
         key, k_rows, k_tree = split(key, 3);
  tree4  GBM and XGBoost single-output: per tree
         key, k_rows, k_cols, k_tree = split(key, 4);
  iter2  multinomial DRF: per iteration key, k_rows = split(key), per
         class tree key, k_tree = split(key);
  iter3  multinomial GBM and XGBoost: per iteration
         key, k_rows, k_cols = split(key, 3), per class tree as iter2.
A tree's level d draws with fold_in(k_tree, d) (the isolation forest:
2d for the columns, 2d + 1 for the thresholds). Row draws are over the
JAX frame's padded rows, cut to the frame's.
"""

import jax
import numpy as np
import torch

from h2o3_tpu_torch.models.tree import engine as TE


def _np_uniform(key, shape):
    return np.array(jax.random.uniform(key, shape))


class JaxDraws:
    """engine.Draws with the JAX package's draws (see the module doc). A
    tree's (an iteration's) keys are split at its first draw; the JAX
    package splits them whether it draws or not, so a tree that draws
    nothing but its level draws still advances the chain. `K` is the
    class trees of an iteration (schemes iter2, iter3)."""

    def __init__(self, seed, pad, scheme, K=1):
        self.key = jax.random.PRNGKey(seed)
        self.pad, self.scheme, self.K = pad, scheme, K
        self.begun = False

    def _begin(self):
        parts = {"tree3": 3, "tree4": 4, "iter2": 2, "iter3": 3}[self.scheme]
        self.key, *ks = jax.random.split(self.key, parts)
        self.k_rows = ks[0]
        self.k_cols = ks[1] if self.scheme in ("tree4", "iter3") else None
        self.k_tree = ks[-1] if self.scheme.startswith("tree") else None
        self.begun, self.klass = True, 0

    def rows(self, n):
        if not self.begun or self.scheme == "tree3":
            self._begin()      # the isolation forest draws no level keys
        return torch.from_numpy(_np_uniform(self.k_rows, (self.pad,))[:n])

    def cols(self, C):
        if not self.begun:
            self._begin()
        return torch.from_numpy(_np_uniform(self.k_cols, (C,)))

    def levels(self):
        if not self.begun:
            self._begin()
        if self.scheme.startswith("iter"):
            self.key, self.k_tree = jax.random.split(self.key)
            self.klass += 1
            self.begun = self.klass < self.K
        else:
            self.begun = False
        k = self.k_tree
        return lambda d, L, C: torch.from_numpy(
            _np_uniform(jax.random.fold_in(k, d), (L, C)))

    def iso_level(self, d, L, C):
        k = self.k_tree
        return (torch.from_numpy(_np_uniform(jax.random.fold_in(k, 2 * d),
                                             (L, C))),
                torch.from_numpy(_np_uniform(
                    jax.random.fold_in(k, 2 * d + 1), (L,))))


def replay(model, seed, pad, scheme, K=1):
    """Make the port estimator `model` draw the JAX package's draws."""
    model._draws = lambda device: JaxDraws(seed, pad, scheme, K)
    return model


def test_draws_are_seeded_uniforms_on_the_rows_device():
    """Each draw of engine.Draws has its shape, lies in [0, 1), and a
    generator seeded alike draws it again the same."""
    def run():
        d = TE.Draws(torch.Generator().manual_seed(5))
        level = d.levels()
        return [d.rows(7), d.cols(4), level(2, 4, 3), *d.iso_level(1, 2, 3)]
    first, again = run(), run()
    assert [tuple(a.shape) for a in first] == [(7,), (4,), (4, 3), (2, 3),
                                               (2,)]
    for a, b in zip(first, again):
        assert a.device.type == "cpu" and a.dtype == torch.float32
        assert bool(((a >= 0) & (a < 1)).all()) and torch.equal(a, b)


def test_replayed_draws_follow_the_jax_key_chain():
    """JaxDraws under scheme tree3 gives a tree's rows and level draws from
    split(PRNGKey(seed), 3), as the JAX package's binomial DRF takes them."""
    key = jax.random.PRNGKey(11)
    _, k1, k2 = jax.random.split(key, 3)
    d = JaxDraws(11, 16, "tree3")
    np.testing.assert_array_equal(d.rows(10).numpy(),
                                  _np_uniform(k1, (16,))[:10])
    np.testing.assert_array_equal(
        d.levels()(3, 8, 5).numpy(),
        _np_uniform(jax.random.fold_in(k2, 3), (8, 5)))
