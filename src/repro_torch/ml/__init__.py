"""Host-side trainers (the paper's Model Trainer component).

This slice carries the trainers of the encode-based (EB) path only; the
lookup-based and direct-map trainers come with their mappers.
"""
from .forest import IsolationForest, RandomForestClassifier, XGBoostClassifier
from .neighbors import KMeans, KNeighborsClassifier
from .tree import DecisionTreeClassifier, XGBRegressionTree

MODEL_REGISTRY = {
    "dt": DecisionTreeClassifier,
    "rf": RandomForestClassifier,
    "xgb": XGBoostClassifier,
    "iforest": IsolationForest,
    "kmeans": KMeans,
    "knn": KNeighborsClassifier,
}

__all__ = [
    "DecisionTreeClassifier", "XGBRegressionTree", "RandomForestClassifier",
    "XGBoostClassifier", "IsolationForest", "KMeans", "KNeighborsClassifier",
    "MODEL_REGISTRY",
]
