"""The analytic multi-chip scaling model (parallel/scaling.py, DESIGN §9):
its dense-exchange byte counts must pin to the same accounting the
multichip dryrun prints (`comm_volume_report`), and its qualitative claims
(dense collapses with mesh size, alltoall holds flat) must hold in the
numbers it emits."""

import re

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.parallel.planner import (
    ROW_SHARDED,
    TABLE_WISE,
    comm_volume_report,
    plan_sharding,
)
from two_tower_recommender_model.parallel.scaling import (
    collective_bytes,
    predict_weak_scaling,
    scaling_table,
)

FLAGSHIP_USERS, FLAGSHIP_ITEMS = 206_209, 49_688


def _dryrun_cfg():
    """The exact 3-table config dryrun_multichip validates."""
    return cfg_lib.ModelConfig(
        tables=(
            cfg_lib.TableConfig("t_user_id", FLAGSHIP_USERS, 128, ("user_id",)),
            cfg_lib.TableConfig("t_product_id", FLAGSHIP_ITEMS, 128, ("product_id",)),
            cfg_lib.TableConfig("t_product_text", FLAGSHIP_ITEMS, 128,
                                ("product_text_id",), dtype="int8"),
        ),
        features=(
            cfg_lib.FeatureConfig("user_id", "t_user_id"),
            cfg_lib.FeatureConfig("product_id", "t_product_id"),
            cfg_lib.FeatureConfig("product_text_id", "t_product_text"),
        ),
        query_tower=cfg_lib.TowerConfig(("user_id",), (128, 64)),
        candidate_tower=cfg_lib.TowerConfig(("product_id", "product_text_id"),
                                            (128, 64)),
    )


def test_dense_bytes_pin_to_dryrun_report():
    """collective_bytes(dense) must equal comm_volume_report line by line —
    the dryrun output (591,360 B/device at bs=128) is the ground truth the
    model extrapolates from."""
    mcfg = _dryrun_cfg()
    plan = plan_sharding(
        mcfg, 8,
        force={"t_user_id": ROW_SHARDED, "t_product_id": TABLE_WISE,
               "t_product_text": ROW_SHARDED},
    )
    report = comm_volume_report(mcfg, plan, 128)
    report_total = int(
        re.search(r"total\s+([\d,]+)", report).group(1).replace(",", ""))
    assert report_total == 591_360

    cm = collective_bytes(mcfg, plan, 128, 8, exchange="dense")
    # the model adds the dense-tower grad psum on top of the table exchange
    dense_psum = cm.per_group["dense towers"]["grad psum"]
    assert cm.total_bytes - dense_psum == report_total
    # per-collective lines match the report's accounting
    for group, colls in cm.per_group.items():
        if group == "dense towers":
            continue
        for coll, nbytes in colls.items():
            assert f"{nbytes:,}" in report, (group, coll, nbytes)


def test_alltoall_bytes_are_local_batch_scaled():
    """alltoall comm is O(B_local): growing the mesh at fixed per-chip batch
    must leave per-device bytes ~flat, while dense grows linearly."""
    mcfg = cfg_lib.two_tower_model_config(
        num_users=FLAGSHIP_USERS, num_items=FLAGSHIP_ITEMS, embedding_dim=128)
    per_chip = 65_536
    totals = {}
    for scheme in ("dense", "alltoall"):
        totals[scheme] = [
            collective_bytes(
                mcfg, plan_sharding(mcfg, n, force={
                    "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED}),
                per_chip * n, n, exchange=scheme,
            ).total_bytes
            for n in (4, 8, 16)
        ]
    d4, d8, d16 = totals["dense"]
    assert d8 / d4 > 1.9 and d16 / d8 > 1.9  # dense doubles with the mesh
    a4, a8, a16 = totals["alltoall"]
    assert a8 / a4 < 1.05 and a16 / a8 < 1.05  # alltoall holds flat
    # and alltoall is far lighter at 8 chips (the ndev/capacity_factor win)
    assert d8 / a8 > 4.0


def test_weak_scaling_predictions():
    """Over NVLink, the dense scheme's predicted efficiency falls as the mesh
    grows while alltoall holds flat, and each cheaper wire (bf16) or overlap
    credit only raises it. The 2 ms single-device step is an assumed input,
    not a measurement."""
    mcfg = cfg_lib.two_tower_model_config(
        num_users=FLAGSHIP_USERS, num_items=FLAGSHIP_ITEMS, embedding_dim=128)
    plan = plan_sharding(mcfg, 8, force={
        "t_user_id": ROW_SHARDED, "t_product_id": ROW_SHARDED})
    step_ms, bs = 2.0, 262_144

    dense = predict_weak_scaling(step_ms, bs, mcfg, plan, 8, exchange="dense")
    dense16 = predict_weak_scaling(step_ms, bs, mcfg, plan, 16, exchange="dense")
    assert dense.efficiency < 0.2  # O(B_global) comm: 12.2%
    assert dense16.efficiency < dense.efficiency

    a2a = predict_weak_scaling(step_ms, bs, mcfg, plan, 8,
                               exchange="alltoall")
    assert a2a.efficiency > 0.7  # no overlap credit: 77%

    a2a_bf16 = predict_weak_scaling(step_ms, bs, mcfg, plan, 8,
                                    exchange="alltoall",
                                    wire_bytes_per_value=2)
    assert a2a_bf16.efficiency > a2a.efficiency

    a2a_overlap = predict_weak_scaling(step_ms, bs, mcfg, plan, 8,
                                       exchange="alltoall",
                                       wire_bytes_per_value=2, overlap=0.5)
    assert a2a_overlap.efficiency > a2a_bf16.efficiency

    # alltoall comm is mesh-flat: 16-device efficiency == 8-device
    a2a16 = predict_weak_scaling(step_ms, bs, mcfg, plan, 16,
                                 exchange="alltoall", wire_bytes_per_value=2)
    assert abs(a2a16.efficiency - a2a_bf16.efficiency) < 0.02

    table = scaling_table(step_ms, bs, mcfg, plan)
    assert "alltoall (bf16 wire)" in table and "dense" in table
    assert "predicted, not measured" in table
