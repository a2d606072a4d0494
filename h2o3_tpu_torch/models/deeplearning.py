"""DeepLearning of the port (h2o3_tpu/models/deeplearning.py,
hex/deeplearning/DeepLearning.java): a multilayer perceptron trained by
synchronous mini-batch gradient descent, one optimizer step a mini-batch.

The net is an `nn.Module` (`MLP`) whose weights keep the JAX package's
layout, W of shape (fan_in, fan_out); a Maxout layer has twice its units
and takes the max of each pair (`torch.amax`, which shares the gradient
of a tie evenly, as `jnp.max` does). Gradients come from autograd. The
optimizer is `torch.optim.Adadelta` at learning rate 1 (optax.adadelta's
update: E[g²] first, then √(E[Δx²]+ε)/√(E[g²]+ε)·g), or `torch.optim.SGD`
with the rate set each step to optax's exponential_decay(rate, 1000,
1/(1+rate_annealing·1000)) and momentum only when momentum_stable is
non-zero.

Random draws: the initial weights and each step's dropout masks come from
`Draws` (one torch.Generator), so that a test can hand the port the JAX
package's key chain instead. The mini-batch rows come from numpy's
default_rng(seed) on the host, one `integers` call a step as in the JAX
package; the rows of `_STEP_CHUNK` steps go to the device in one copy.

Inherited from the JAX package as it is (ROADMAP.md §3): input dropout
is not rescaled by 1/(1-d); a `*WithDropout` activation without
`hidden_dropout_ratios` drops nothing; no early stopping.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from h2o3_tpu_torch.core.frame import Frame
from h2o3_tpu_torch.models.model import ModelBase, _matrix_frame

# steps whose mini-batch rows are drawn ahead and copied in one transfer
_STEP_CHUNK = 512
# rows scored in one pass (bounds the hidden layers' activations)
_SCORE_ROWS = 1 << 20
_JAX_FIT = "h2o3_tpu/models/deeplearning.py:_fit"


def _activation(name: str):
    name = (name or "Rectifier").lower()
    if "rectifier" in name:
        return torch.relu
    if "tanh" in name:
        return torch.tanh
    if "maxout" in name:
        return None         # pairs of units, in MLP.forward
    raise ValueError(name)


class Draws:
    """The random draws of a DeepLearning fit, from one torch.Generator,
    landing on `device`: each layer's initial weights, then each step's
    dropout masks. The JAX package draws them from a jax.random key chain
    (PRNGKey(seed), one split a layer, one a step, one a mask); a test
    replaces this object to hand both packages the same draws."""

    def __init__(self, gen: torch.Generator, device=None):
        self.gen = gen
        self.device = torch.device(device) if device is not None \
            else gen.device

    def weights(self, shape, lim):
        """(fan_in, fan_out) f32 uniforms on [-lim, lim)."""
        u = torch.empty(shape, dtype=torch.float32, device=self.gen.device)
        return u.uniform_(-lim, lim, generator=self.gen).to(self.device)

    def step(self):
        """One step's draws: a function of a shape giving [0, 1) uniforms,
        called for each dropout mask in the order of the forward pass."""
        return self._rand

    def _rand(self, shape):
        return torch.rand(shape, generator=self.gen,
                          device=self.gen.device).to(self.device)


class MLP(torch.nn.Module):
    """The net: hidden layers of `activation`, then a linear output layer.
    `forward(x, draw)` with a step's draws applies dropout: the input mask
    unscaled, hidden masks scaled by 1/(1-d), as the JAX package does."""

    def __init__(self, layers, activation, input_dropout=0.0,
                 hidden_dropout=None):
        super().__init__()
        self.W = torch.nn.ParameterList(
            [torch.nn.Parameter(W) for W, _ in layers])
        self.b = torch.nn.ParameterList(
            [torch.nn.Parameter(b) for _, b in layers])
        self.act = _activation(activation)
        self.in_drop = float(input_dropout or 0.0)
        self.hid_drop = list(hidden_dropout or [])

    def forward(self, x, draw=None):
        h = x
        if draw is not None and self.in_drop > 0:
            h = h * (draw(h.shape) > self.in_drop)
        last = len(self.W) - 1
        for i in range(last):
            z = torch.addmm(self.b[i], h, self.W[i])
            if self.act is None:
                z = torch.amax(z.view(z.shape[0], -1, 2), dim=2)
            else:
                z = self.act(z)
            d = float(self.hid_drop[i]) if i < len(self.hid_drop) else 0.0
            if draw is not None and d > 0:
                z = z * (draw(z.shape) > d) / (1 - d)
            h = z
        return torch.addmm(self.b[last], h, self.W[last])


class _Layers:
    """Given (W, b) lists, the forward of an MLP's layers, its activation
    taken from the net it mirrors (the serving params' net)."""

    def __init__(self, W, b, like: MLP):
        self.W, self.b = W, b
        self.act = like.act
        self.in_drop = 0.0
        self.hid_drop = []

    def __call__(self, x):
        return MLP.forward(self, x)


def _batches(rng, n, mb, nsteps, device):
    """(step, (mb,) int64 row ids on `device`) for each step: one
    rng.integers(0, n, size=mb) call a step, in the JAX package's order,
    copied to the device a chunk of steps at a time."""
    for c0 in range(0, nsteps, _STEP_CHUNK):
        c1 = min(nsteps, c0 + _STEP_CHUNK)
        idx = torch.from_numpy(np.stack(
            [rng.integers(0, n, size=mb) for _ in range(c0, c1)])).to(device)
        for s in range(c0, c1):
            yield s, idx[s - c0]


class H2ODeepLearningEstimator(ModelBase):
    algo = "deeplearning"
    _serving_param_attrs = ("_params_net",)
    _partition_rules = ((r"^_params_net/\d+/0$", (None, "model")),
                        (r"^_params_net/\d+/1$", ("model",)))
    _defaults = {
        "hidden": None, "epochs": 10.0, "activation": "Rectifier",
        "adaptive_rate": True, "rho": 0.99, "epsilon": 1e-8,
        "rate": 0.005, "rate_annealing": 1e-6, "rate_decay": 1.0,
        "momentum_start": 0.0, "momentum_ramp": 1e6, "momentum_stable": 0.0,
        "input_dropout_ratio": 0.0, "hidden_dropout_ratios": None,
        "l1": 0.0, "l2": 0.0, "loss": "Automatic", "mini_batch_size": 1,
        "autoencoder": False, "train_samples_per_iteration": -2,
        "score_interval": 5.0, "initial_weight_distribution": "UniformAdaptive",
        "initial_weight_scale": 1.0, "stopping_rounds": 5,
        "stopping_metric": "AUTO", "stopping_tolerance": 0.0,
        "max_w2": float("inf"), "standardize": True, "reproducible": False,
        "export_weights_and_biases": False, "shuffle_training_data": False,
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + tuple(
        (name, default, f"the JAX package accepts it and never reads it "
                        f"({_JAX_FIT})")
        for name, default in (
            # 0 turns early stopping off, as the JAX package never stops
            ("stopping_rounds", (5, 0)), ("stopping_metric", "AUTO"),
            ("stopping_tolerance", 0.0), ("max_w2", float("inf")),
            ("initial_weight_distribution", "UniformAdaptive"),
            ("initial_weight_scale", 1.0), ("rate_decay", 1.0),
            ("momentum_start", 0.0), ("momentum_ramp", 1e6),
            ("train_samples_per_iteration", -2),
            ("shuffle_training_data", False), ("reproducible", False)))
    supervised = True

    def train(self, x=None, y=None, training_frame=None, **kw):
        self.supervised = not bool(self.params.get("autoencoder")
                                   or kw.get("autoencoder"))
        return ModelBase.train(self, x=x, y=y if self.supervised else None,
                               training_frame=training_frame, **kw)

    def _draws(self, device) -> Draws:
        """The fit's draws: a generator on the device, seeded as the JAX
        package seeds its key (seed, or 0 when unset)."""
        seed = int(self.params.get("seed") or -1)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed if seed > 0 else 0)
        return Draws(gen, device)

    def _check_loss(self, loss_kind):
        """The JAX package never reads `loss`: it takes cross-entropy for a
        classifier and the squared error otherwise. Any other loss raises."""
        want = "crossentropy" if loss_kind == "ce" else "quadratic"
        got = str(self.params.get("loss") or "Automatic").lower()
        if got not in ("automatic", want):
            raise NotImplementedError(
                f"deeplearning: loss={self.params['loss']!r} is not "
                f"supported: the JAX package accepts it and never reads it "
                f"({_JAX_FIT})")

    # ------------------------------------------------------------------
    def _fit(self, frame: Frame):
        di = self._dinfo
        job = self._job
        X = di.matrix(frame)
        w = di.weights(frame)
        Xz = torch.where(torch.isnan(X), 0.0, X)
        dev = X.device
        autoenc = bool(self.params.get("autoencoder"))
        if autoenc:
            Y, out_dim, loss_kind = Xz, X.shape[1], "quadratic"
        else:
            yv = di.response(frame)
            w = torch.where(torch.isnan(yv), 0.0, w)
            yz = torch.where(torch.isnan(yv), 0.0, yv)
            if self._is_classifier:
                Y, out_dim, loss_kind = yz.long(), self.nclasses, "ce"
            else:
                Y, out_dim, loss_kind = yz, 1, "quadratic"
        self._check_loss(loss_kind)
        hidden = list(self.params.get("hidden") or [200, 200])
        act = self.params.get("activation")
        maxout = _activation(act) is None
        seed = int(self.params.get("seed") or -1)
        draws = self._draws(dev)
        dims = [X.shape[1]] + hidden + [out_dim]
        layers = []
        for i in range(len(dims) - 1):
            fan_in, fan_out = dims[i], dims[i + 1]
            if maxout and i < len(dims) - 2:
                fan_out *= 2
            # UniformAdaptive init (Neurons.java): U(±√(6/(fi+fo))) over
            # the undoubled dims
            lim = math.sqrt(6.0 / (dims[i] + dims[i + 1]))
            layers.append((draws.weights((fan_in, fan_out), lim),
                           torch.zeros(fan_out, device=dev)))
        net = MLP(layers, act, self.params.get("input_dropout_ratio"),
                  self.params.get("hidden_dropout_ratios"))
        l1 = float(self.params.get("l1") or 0.0)
        l2 = float(self.params.get("l2") or 0.0)

        def loss_fn(xb, yb, wb, draw):
            out = net(xb, draw)
            if loss_kind == "ce":
                ll = torch.nn.functional.cross_entropy(out, yb,
                                                       reduction="none")
            elif autoenc:
                ll = ((out - yb) ** 2).mean(dim=-1)
            else:
                ll = (out[:, 0] - yb) ** 2
            base = (wb * ll).sum() / torch.clamp(wb.sum(), min=1e-8)
            if l1 or l2:
                base = base + (sum(W.abs().sum() for W in net.W) * l1
                               + sum((W * W).sum() for W in net.W) * l2)
            return base

        if self.params.get("adaptive_rate", True):
            opt = torch.optim.Adadelta(net.parameters(), lr=1.0,
                                       rho=float(self.params["rho"]),
                                       eps=float(self.params["epsilon"]))
            rate = None
        else:
            rate = float(self.params["rate"])
            decay = 1.0 / (1.0 + float(self.params["rate_annealing"]) * 1000)
            opt = torch.optim.SGD(
                net.parameters(), lr=rate,
                momentum=float(self.params.get("momentum_stable") or 0.0))

        n = frame.nrows
        epochs = float(self.params.get("epochs") or 10.0)
        mb = int(self.params.get("mini_batch_size") or 1)
        if mb <= 1:
            mb = min(256, max(32, n // 16 or 32))  # sync-SGD friendly batch
        nsteps = max(1, int(epochs * n / mb))
        every = max(1, nsteps // 10)
        rng = np.random.default_rng(seed if seed > 0 else 0)
        history = []
        for s, idx in _batches(rng, n, mb, nsteps, dev):
            if rate is not None:
                for g in opt.param_groups:
                    g["lr"] = rate * decay ** (s / 1000)
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(Xz.index_select(0, idx), Y.index_select(0, idx),
                           w.index_select(0, idx), draws.step())
            loss.backward()
            opt.step()
            if s % every == 0 or s == nsteps - 1:
                history.append({"samples": (s + 1) * mb,
                                "epochs": (s + 1) * mb / n,
                                "training_loss": loss.item()})
                if job is not None:
                    if job.budget_exhausted:
                        break
                    job.update(0.1 + 0.8 * (s + 1) / nsteps,
                               f"epoch {(s + 1) * mb / n:.2f}")
        net.requires_grad_(False)
        self._net = net
        self._loss_kind = loss_kind
        self._output.scoring_history = history
        self._output.model_summary = {
            "hidden": hidden, "activation": act,
            "epochs_trained": nsteps * mb / n,
            "weights": [list(W.shape) for W in net.W],
        }

    @property
    def _params_net(self):
        """The net's (W, b) per layer, as the JAX package keeps them."""
        return [(W, b) for W, b in zip(self._net.W, self._net.b)]

    # ------------------------------------------------------------------
    def _score_matrix(self, X):
        return self._score_net(self._net, X)

    def _score_with_params(self, params, X):
        """The placed (W, b) layers stand in for the net's parameters: the
        same forward (`MLP.forward` without draws) over them."""
        layers = params["_params_net"]
        net = _Layers([W for W, _ in layers], [b for _, b in layers],
                      self._net)
        return self._score_net(net, X)

    def _score_net(self, net, X):
        Xz = torch.where(torch.isnan(X), 0.0, X)
        with torch.no_grad():
            out = torch.cat([net(Xz[r:r + _SCORE_ROWS])
                             for r in range(0, max(1, Xz.shape[0]),
                                            _SCORE_ROWS)])
            if self.params.get("autoencoder"):
                return out
            if self._is_classifier:
                return torch.softmax(out, dim=1)
            return out[:, 0]

    def _prediction_columns(self, out, n: int) -> list:
        # here rather than in an override of predict: the base predict is
        # what makes a model ride the micro-batcher (serving/__init__.py)
        if self.params.get("autoencoder"):
            # the JAX package's prediction frame cannot hold the (n, p)
            # reconstruction and raises ValueError too
            raise ValueError("deeplearning: an autoencoder has no "
                             "prediction frame; use anomaly()")
        return ModelBase._prediction_columns(self, out, n)

    def anomaly(self, test_data: Frame) -> Frame:
        """Autoencoder per-row reconstruction MSE (H2O h2o.anomaly)."""
        X = self._dinfo.matrix(test_data)
        Xz = torch.where(torch.isnan(X), 0.0, X)
        mse = ((self._score_matrix(X) - Xz) ** 2).mean(dim=1)
        return _matrix_frame(["Reconstruction.MSE"], mse[:, None])

    def _score_train_valid(self, frame, valid):
        if self.params.get("autoencoder"):
            return
        ModelBase._score_train_valid(self, frame, valid)
