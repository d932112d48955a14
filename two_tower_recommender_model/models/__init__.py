from two_tower_recommender_model.models.two_tower import (  # noqa: F401
    init_params,
    forward,
    pooled_embeddings,
    towers_forward,
)
from two_tower_recommender_model.models import losses, metrics  # noqa: F401
