"""Host-side trainers (the paper's Model Trainer component).

The numpy trainers are copies of the JAX package's; ``bnn`` trains in
PyTorch on the device ``plant`` is given.
"""
from .bayes import CategoricalNB
from .bnn import BinarizedMLP, bits_pm1
from .forest import IsolationForest, RandomForestClassifier, XGBoostClassifier
from .linear import Autoencoder, LinearSVM, PCA
from .neighbors import KMeans, KNeighborsClassifier
from .ngram import NGramModel
from .tree import DecisionTreeClassifier, XGBRegressionTree

MODEL_REGISTRY = {
    "dt": DecisionTreeClassifier,
    "rf": RandomForestClassifier,
    "xgb": XGBoostClassifier,
    "iforest": IsolationForest,
    "ngram": NGramModel,
    "svm": LinearSVM,
    "nb": CategoricalNB,
    "kmeans": KMeans,
    "knn": KNeighborsClassifier,
    "pca": PCA,
    "ae": Autoencoder,
    "bnn": BinarizedMLP,
}

__all__ = [
    "DecisionTreeClassifier", "XGBRegressionTree", "RandomForestClassifier",
    "XGBoostClassifier", "IsolationForest", "LinearSVM", "PCA", "Autoencoder",
    "CategoricalNB", "KMeans", "KNeighborsClassifier", "BinarizedMLP",
    "NGramModel", "bits_pm1", "MODEL_REGISTRY",
]
