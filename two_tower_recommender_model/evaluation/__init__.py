from two_tower_recommender_model.evaluation.retrieval import (  # noqa: F401
    evaluate_retrieval,
    export_feature_embeddings,
    retrieval_metrics,
)
