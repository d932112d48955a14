from two_tower_recommender_model.serving.scorer import (  # noqa: F401
    Scorer,
    load_scorer,
    load_scorer_from_registry,
)
from two_tower_recommender_model.serving.retrieval_service import RetrievalService  # noqa: F401,E501
