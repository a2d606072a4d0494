"""Models of the port (h2o3_tpu/models)."""

from h2o3_tpu_torch.models.aggregator import H2OAggregatorEstimator
from h2o3_tpu_torch.models.coxph import H2OCoxProportionalHazardsEstimator
from h2o3_tpu_torch.models.deeplearning import H2ODeepLearningEstimator
from h2o3_tpu_torch.models.ensemble import H2OStackedEnsembleEstimator
from h2o3_tpu_torch.models.extended_isofor import \
    H2OExtendedIsolationForestEstimator
from h2o3_tpu_torch.models.gam import H2OGeneralizedAdditiveEstimator
from h2o3_tpu_torch.models.generic import H2OGenericEstimator
from h2o3_tpu_torch.models.glm import H2OGeneralizedLinearEstimator
from h2o3_tpu_torch.models.glrm import H2OGeneralizedLowRankEstimator
from h2o3_tpu_torch.models.grid import H2OGridSearch
from h2o3_tpu_torch.models.infogram import H2OInfogram
from h2o3_tpu_torch.models.kmeans import H2OKMeansEstimator
from h2o3_tpu_torch.models.naive_bayes import H2ONaiveBayesEstimator
from h2o3_tpu_torch.models.pca import H2OPrincipalComponentAnalysisEstimator
from h2o3_tpu_torch.models.psvm import H2OSupportVectorMachineEstimator
from h2o3_tpu_torch.models.rulefit import H2ORuleFitEstimator
from h2o3_tpu_torch.models.segments import SegmentModels, train_segments
from h2o3_tpu_torch.models.svd import H2OSingularValueDecompositionEstimator
from h2o3_tpu_torch.models.target_encoder import H2OTargetEncoderEstimator
from h2o3_tpu_torch.models.tree.drf import H2ORandomForestEstimator
from h2o3_tpu_torch.models.tree.gbm import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.tree.isofor import H2OIsolationForestEstimator
from h2o3_tpu_torch.models.tree.xgboost import H2OXGBoostEstimator
from h2o3_tpu_torch.models.word2vec import H2OWord2vecEstimator

# generated parameter docs (h2o-bindings gen_python.py docstring surface)
from h2o3_tpu_torch.models.param_docs import document as _document

# algo name -> estimator class: the REST builders' table
# (/3/ModelBuilders/{algo}) and the extension SPI's merge target
ESTIMATORS = {
    "kmeans": H2OKMeansEstimator,
    "glm": H2OGeneralizedLinearEstimator,
    "gbm": H2OGradientBoostingEstimator,
    "drf": H2ORandomForestEstimator,
    "isolationforest": H2OIsolationForestEstimator,
    "deeplearning": H2ODeepLearningEstimator,
    "pca": H2OPrincipalComponentAnalysisEstimator,
    "glrm": H2OGeneralizedLowRankEstimator,
    "naivebayes": H2ONaiveBayesEstimator,
    "svd": H2OSingularValueDecompositionEstimator,
    "aggregator": H2OAggregatorEstimator,
    "stackedensemble": H2OStackedEnsembleEstimator,
    "targetencoder": H2OTargetEncoderEstimator,
    "word2vec": H2OWord2vecEstimator,
    "coxph": H2OCoxProportionalHazardsEstimator,
    "extendedisolationforest": H2OExtendedIsolationForestEstimator,
    "gam": H2OGeneralizedAdditiveEstimator,
    "rulefit": H2ORuleFitEstimator,
    "generic": H2OGenericEstimator,
    "psvm": H2OSupportVectorMachineEstimator,
    "xgboost": H2OXGBoostEstimator,
}

for _cls in set(ESTIMATORS.values()):
    _document(_cls)

__all__ = ["ESTIMATORS", "H2OAggregatorEstimator", "H2OCoxProportionalHazardsEstimator",
           "H2ODeepLearningEstimator", "H2OExtendedIsolationForestEstimator",
           "H2OGeneralizedAdditiveEstimator", "H2OGenericEstimator",
           "H2OGeneralizedLinearEstimator", "H2OGeneralizedLowRankEstimator",
           "H2OGradientBoostingEstimator", "H2OGridSearch", "H2OInfogram",
           "H2OIsolationForestEstimator", "H2OKMeansEstimator",
           "H2ONaiveBayesEstimator",
           "H2OPrincipalComponentAnalysisEstimator",
           "H2ORandomForestEstimator", "H2ORuleFitEstimator",
           "H2OSingularValueDecompositionEstimator",
           "H2OStackedEnsembleEstimator",
           "H2OSupportVectorMachineEstimator", "H2OTargetEncoderEstimator",
           "H2OWord2vecEstimator", "H2OXGBoostEstimator",
           "SegmentModels", "train_segments"]
