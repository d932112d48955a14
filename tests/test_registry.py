"""Model registry: numbered versions, stage lifecycle, load-by-stage."""

import jax
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.train.step import create_train_state
from two_tower_recommender_model.utils.registry import ModelRegistry, register_from_run
from two_tower_recommender_model.utils.tracking import ExperimentLogger


@pytest.fixture
def setup(tmp_path):
    mcfg = cfg_lib.two_tower_model_config(num_users=20, num_items=10, embedding_dim=4,
                                          layer_sizes=(8, 4))
    tcfg = cfg_lib.TrainConfig()
    state, _ = create_train_state(jax.random.key(0), mcfg, tcfg)
    return ModelRegistry(str(tmp_path / "registry")), mcfg, state


def test_register_versions_and_stages(setup):
    reg, mcfg, state = setup
    v1 = reg.register("two_tower", mcfg, state, description="first")
    v2 = reg.register("two_tower", mcfg, state, description="second")
    assert (v1, v2) == (1, 2)
    assert reg.list_models() == ["two_tower"]
    assert reg.get_version("two_tower", "latest")["version"] == 2

    reg.set_stage("two_tower", 1, "Production")
    assert reg.get_version("two_tower", "Production")["version"] == 1
    # promoting v2 archives v1 (mlflow archive_existing_versions behavior)
    reg.set_stage("two_tower", 2, "Production")
    assert reg.get_version("two_tower", "Production")["version"] == 2
    assert reg.get_version("two_tower", 1)["stage"] == "Archived"

    cfg2, params = reg.load("two_tower", "Production")
    assert cfg2.tower_out_dim == mcfg.tower_out_dim
    np.testing.assert_allclose(params["tables"]["t_user_id"],
                               np.asarray(state.tables["t_user_id"]), rtol=1e-6)

    with pytest.raises(ValueError):
        reg.set_stage("two_tower", 2, "NotAStage")
    with pytest.raises(FileNotFoundError):
        reg.get_version("two_tower", 99)

    reg.delete_version("two_tower", 1)
    with pytest.raises(FileNotFoundError):
        reg.get_version("two_tower", 1)


def test_register_from_run_carries_metrics(setup, tmp_path):
    reg, mcfg, state = setup
    logger = ExperimentLogger(str(tmp_path / "runs"))
    logger.log_params({"lr": 1e-3})
    logger.log_metrics({"val_auroc": 0.91, "note": "x"}, step=10)
    v = register_from_run(reg, "m", logger, mcfg, state, description="from run")
    e = reg.get_version("m", v)
    assert e["run_id"] == logger.run_id
    assert e["metrics"]["val_auroc"] == 0.91
    assert "note" not in e["metrics"]  # non-numeric values dropped


def test_serve_from_registry_by_stage(setup):
    from two_tower_recommender_model.serving.scorer import load_scorer_from_registry

    reg, mcfg, state = setup
    v = reg.register("serveme", mcfg, state)
    reg.set_stage("serveme", v, "Production")
    scorer = load_scorer_from_registry(reg.root, "serveme", "Production")
    p = scorer.predict({"user_id": [1, 2], "product_id": [3, 4]})
    assert p.shape == (2,) and np.isfinite(p).all()
