from two_tower_recommender_model.train.step import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_multi_step,
    make_train_step,
    stack_batches,
)
from two_tower_recommender_model.train.loop import evaluate, train_val_test  # noqa: F401
from two_tower_recommender_model.train.resilient import resilient_fit  # noqa: F401
