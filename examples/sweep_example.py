"""Hyperparameter sweep example — the reference's Ray Tune + Optuna workflow
(`ray_tune_optuna_tuning_alex_test.py:594-669`) on this framework's sweep
driver: search layer sizes + both learning rates + batch size, rank by
val_loss, report the best config, then a vmapped multi-seed run of the winner.
"""

from __future__ import annotations

import dataclasses

import jax

from two_tower_recommender_model import config as cfg
from two_tower_recommender_model.data import Featurizer, SyntheticClickstream
from two_tower_recommender_model.train import (
    create_train_state, make_eval_step, make_train_step)
from two_tower_recommender_model.train.loop import evaluate
from two_tower_recommender_model.train.pipeline import prefetch_to_device
from two_tower_recommender_model.tuning import (
    Choice, LogUniform, multi_seed_train, run_sweep)

N_USERS, N_ITEMS = 500, 200
DS = SyntheticClickstream(N_USERS, N_ITEMS, seed=3, noise=0.05, latent_dim=4)

# the reference's space: per-tower layer sizes choice, mlp_lr/ebc_lr
# loguniform, batch-size choice (ray_tune...py:600-612)
SPACE = {
    "layer_sizes": Choice(((64, 32), (128, 64), (128, 64, 32))),
    "mlp_lr": LogUniform(1e-4, 1e-2),
    "ebc_lr": LogUniform(1e-3, 2e-1),
    "batch_size": Choice((256, 512)),
}


def trial(config) -> dict:
    mcfg = cfg.two_tower_model_config(
        N_USERS, N_ITEMS, embedding_dim=32, layer_sizes=tuple(config["layer_sizes"]))
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg.TrainConfig(
        learning_rate=config["mlp_lr"], sparse_learning_rate=config["ebc_lr"])
    feat = Featurizer(mcfg)
    state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
    tstep = make_train_step(mcfg, tcfg, dense_opt)
    for batch in prefetch_to_device(DS.batches(config["batch_size"], 120), feat):
        state, _ = tstep(state, batch)
    metrics = evaluate(state, make_eval_step(mcfg, tcfg),
                       DS.batches(512, 6, "val"), feat)
    return metrics


def trial_resumable(config, grow_epochs, state_pack):
    """ASHA-style resumable trial: train `grow_epochs` more epochs from the
    carried state and report val_loss (tuning.adaptive.run_asha contract)."""
    mcfg = cfg.two_tower_model_config(
        N_USERS, N_ITEMS, embedding_dim=32, layer_sizes=tuple(config["layer_sizes"]))
    mcfg = dataclasses.replace(
        mcfg,
        query_tower=dataclasses.replace(mcfg.query_tower, final_activation=False),
        candidate_tower=dataclasses.replace(mcfg.candidate_tower, final_activation=False))
    tcfg = cfg.TrainConfig(
        learning_rate=config["mlp_lr"], sparse_learning_rate=config["ebc_lr"])
    feat = Featurizer(mcfg)
    if state_pack is None:
        state, dense_opt = create_train_state(jax.random.key(0), mcfg, tcfg)
        epoch = 0
    else:
        state, dense_opt, epoch = state_pack
    tstep = make_train_step(mcfg, tcfg, dense_opt, donate=False)
    for e in range(epoch, epoch + grow_epochs):
        for batch in prefetch_to_device(DS.batches(config["batch_size"], 40,
                                                   split=f"ep{e}"), feat):
            state, _ = tstep(state, batch)
    metrics = evaluate(state, make_eval_step(mcfg, tcfg), DS.batches(512, 6, "val"), feat)
    return (state, dense_opt, epoch + grow_epochs), metrics


def main():
    # 1. TPE-guided sweep (the OptunaSearch role) — later trials concentrate
    #    near the best observed region
    result = run_sweep(trial, SPACE, num_trials=8, metric="val_loss", mode="min",
                       seed=0, search="tpe")
    print(result.table())
    best = result.best()
    print("\nbest config:", best.config)
    print("best val_loss:", round(best.metrics["val_loss"], 4),
          "val_auroc:", round(best.metrics["val_auroc"], 4))

    # 2. ASHA early stopping: bad configs are cut after 1 epoch; survivors
    #    train the full budget (the Tune scheduler role)
    from two_tower_recommender_model.tuning.adaptive import (
        asha_best, asha_total_resource, run_asha)

    trials = run_asha(trial_resumable, SPACE, num_trials=8, metric="val_loss",
                      min_resource=1, max_resource=4, eta=2, seed=1)
    winner = asha_best(trials)
    print(f"\nASHA: best val_loss {winner.metric_value:.4f} at {winner.config}; "
          f"total epochs spent {asha_total_resource(trials)} "
          f"(full-budget would be {8 * 4})")

    # seed robustness of the winner, S models in one compiled program
    mcfg = cfg.two_tower_model_config(N_USERS, N_ITEMS, embedding_dim=32,
                                      layer_sizes=tuple(best.config["layer_sizes"]))
    tcfg = cfg.TrainConfig(learning_rate=best.config["mlp_lr"],
                           sparse_learning_rate=best.config["ebc_lr"])
    ms = multi_seed_train(mcfg, tcfg, seeds=[0, 1, 2, 3],
                          train_batches=DS.batches(best.config["batch_size"], 60),
                          eval_batch=DS.sample(2048, "val"))
    print("multi-seed eval AUROC:", ms["eval_auroc"].round(4).tolist())
    assert best.metrics["val_auroc"] > 0.6
    print("SWEEP OK")


if __name__ == "__main__":
    main()
