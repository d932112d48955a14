from two_tower_recommender_model.tuning.sweep import (  # noqa: F401
    Choice,
    LogUniform,
    Uniform,
    run_sweep,
    sample_space,
)
from two_tower_recommender_model.tuning.multi_seed import multi_seed_train  # noqa: F401
