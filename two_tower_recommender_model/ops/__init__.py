from two_tower_recommender_model.ops.embedding_ops import (  # noqa: F401
    pooled_lookup,
    row_grads_from_pooled,
)
from two_tower_recommender_model.ops.topk import chunked_topk  # noqa: F401
