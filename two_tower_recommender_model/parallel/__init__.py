from two_tower_recommender_model.parallel.mesh import make_mesh, topology_summary  # noqa: F401
from two_tower_recommender_model.parallel.planner import (  # noqa: F401
    ShardingPlan,
    TableShard,
    plan_sharding,
)
from two_tower_recommender_model.parallel.sharded import (  # noqa: F401
    batch_sharding,
    compact_macro_shardings,
    compact_macro_shardings_for_scheme,
    macro_batch_sharding,
    make_sharded_compact_multi_step,
    make_sharded_eval_step,
    make_sharded_multi_step,
    make_sharded_topk,
    make_sharded_train_step,
    shard_train_state,
    unshard_train_state,
)
