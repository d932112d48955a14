from two_tower_recommender_model.data.featurizer import (  # noqa: F401
    Batch,
    SparseFeature,
    Featurizer,
)
from two_tower_recommender_model.data.synthetic import SyntheticClickstream  # noqa: F401
from two_tower_recommender_model.data.prepacked import (  # noqa: F401
    PrepackedFeaturizer,
    pack_dataset,
)
