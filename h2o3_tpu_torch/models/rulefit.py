"""RuleFit of the port (h2o3_tpu/models/rulefit.py; hex/rulefit/RuleFit.java):
tree-ensemble rules and a sparse GLM.

For each rule length D in [min_rule_length, max_rule_length] a GBM of
depth D grows (at most 20 trees, seed 1, learn rate 0.1, sample rate 0.8,
as in the JAX package), and every terminal node of its trees becomes a
0/1 rule column: the rows the tree sends there (`engine.predict_leaf_ids`
over the GBM's own design, NA routed as the tree routes it). A rule is
kept when its support lies strictly between 1% and 99% of the frame's
rows. With `model_type` "rules_and_linear" the numeric predictors join
as `linear_<column>`. An L1 GLM (alpha 1, a 15-step lambda search, 20
iterations a lambda) fits the rule and linear columns; its nonzero
coefficients rank the rules (`rule_importance`).

The rule and linear columns are rows of one f32 tensor on the frame's
device, one Vec a row, not host float64 columns. The JAX package walks
the trees over its own standardised, imputed one-hot design and counts a
rule's support over the frame's padded rows; the port walks the rows as
the GBM saw them and counts over the frame's rows (ROADMAP.md §3).
"""

from __future__ import annotations

import time

import torch

from h2o3_tpu_torch.core.frame import Frame, Vec
from h2o3_tpu_torch.core.kvstore import DKV
from h2o3_tpu_torch.models.glm import H2OGeneralizedLinearEstimator
from h2o3_tpu_torch.models.model import ModelBase
from h2o3_tpu_torch.models.tree import engine as E
from h2o3_tpu_torch.models.tree.shared_tree import H2OGradientBoostingEstimator

# the trees of each rule length's GBM, at most (the JAX package's cap)
MAX_RULE_TREES = 20


class H2ORuleFitEstimator(ModelBase):
    algo = "rulefit"
    _defaults = {
        "min_rule_length": 3, "max_rule_length": 3, "max_num_rules": -1,
        "model_type": "rules_and_linear", "rule_generation_ntrees": 50,
        "algorithm": "AUTO",
    }
    _IGNORED_IN_JAX = ModelBase._IGNORED_IN_JAX + (
        ("algorithm", ("AUTO", "GBM", "gbm"),
         "the JAX package always grows the rules with GBM "
         "(h2o3_tpu/models/rulefit.py:43)"),)

    def _rule_gbm(self, depth: int, ntrees: int, frame: Frame):
        """The GBM whose terminal nodes are the rules of length `depth`."""
        gbm = H2OGradientBoostingEstimator(
            ntrees=ntrees, max_depth=depth, seed=1, learn_rate=0.1,
            sample_rate=0.8)
        return gbm.train(x=self._dinfo.predictors,
                         y=self._dinfo.response_name, training_frame=frame)

    def _fit(self, frame: Frame):
        di = self._dinfo
        y = di.response_name
        n = frame.nrows
        dev = frame.vecs[0].device
        ntrees = min(int(self.params["rule_generation_ntrees"]),
                     MAX_RULE_TREES)
        depths = range(int(self.params["min_rule_length"]),
                       int(self.params["max_rule_length"]) + 1)
        timings = {"gbm": 0.0, "rule columns": 0.0, "glm": 0.0}
        rules = []
        acts = []            # (n,) bool activations of the kept rules
        for D in depths:
            t0 = time.perf_counter()
            gbm = self._rule_gbm(D, ntrees, frame)
            timings["gbm"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            trees = gbm._trees.to(dev)
            nodes, _ = E.predict_leaf_ids(gbm._dinfo.matrix(frame), trees)
            n_nodes = trees.col.shape[1]
            support = torch.stack([torch.bincount(nodes[t],
                                                  minlength=n_nodes)
                                   for t in range(trees.ntrees)]).cpu()
            for t in range(trees.ntrees):
                for nd in torch.nonzero(support[t]).flatten().tolist():
                    cnt = int(support[t, nd])
                    if 0.01 * n < cnt < 0.99 * n:
                        name = f"rule_D{D}_T{t}_N{nd}"
                        acts.append((nodes[t], nd))
                        rules.append({"name": name, "depth": D, "tree": t,
                                      "node": int(nd), "support": cnt / n})
            timings["rule columns"] += time.perf_counter() - t0
            DKV.remove(gbm.key)
        mx = int(self.params.get("max_num_rules") or -1)
        names = [r["name"] for r in rules]
        if mx > 0 and len(names) > mx:
            names, acts = names[:mx], acts[:mx]
        lin = []
        if "linear" in (self.params.get("model_type") or ""):
            lin = list(di.num_cols)
        t0 = time.perf_counter()
        feats = torch.empty((len(names) + len(lin), n), dtype=torch.float32,
                            device=dev)
        for j, (leaf_of_row, nd) in enumerate(acts):
            feats[j] = leaf_of_row == nd
        for j, c in enumerate(lin):
            feats[len(names) + j] = frame.vec(c).as_f32()
        fnames = names + [f"linear_{c}" for c in lin]
        lf = Frame(fnames + [y], [Vec.from_tensor(feats[j])
                                  for j in range(len(fnames))]
                   + [frame.vec(y)])
        acts = nodes = None
        timings["rule columns"] += time.perf_counter() - t0
        dom = di.response_domain
        fam = "binomial" if dom and len(dom) == 2 else (
            "multinomial" if dom else "gaussian")
        t0 = time.perf_counter()
        glm = H2OGeneralizedLinearEstimator(family=fam, alpha=1.0,
                                            lambda_search=True, nlambdas=15,
                                            max_iterations=20)
        glm.train(y=y, training_frame=lf)
        timings["glm"] = time.perf_counter() - t0
        DKV.remove(lf.key)
        del lf, feats
        self._glm = glm
        self._rules = rules
        self._rule_names = fnames
        self._timings = timings
        self._output.training_metrics = glm._output.training_metrics
        coefs = glm.coef() if fam != "multinomial" else {}
        active = {k: v for k, v in coefs.items()
                  if abs(v) > 1e-8 and k != "Intercept"}
        self._output.model_summary = {
            "rules_generated": len(rules),
            "rules_selected": len(active),
        }
        self._rule_importance = sorted(
            ({"rule": k, "coefficient": v} for k, v in active.items()),
            key=lambda r: -abs(r["coefficient"]))
        self._depths = list(depths)
        self._frame_key = frame.key

    def rule_importance(self):
        return self._rule_importance

    def predict(self, test_data: Frame) -> Frame:
        raise NotImplementedError(
            "RuleFit fits the rules and their sparse GLM (rule_importance); "
            "scoring new rows needs the rule re-evaluator, as in the JAX "
            "package")

    def _compute_metrics(self, frame):
        return self._output.training_metrics

    def _score_train_valid(self, frame, valid):
        pass
