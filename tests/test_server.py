"""HTTP model server: invocation contract, payload forms, errors, capture,
batch inference."""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from two_tower_recommender_model import config as cfg_lib
from two_tower_recommender_model.data.shards import ShardedDataset, write_dataset
from two_tower_recommender_model.models.two_tower import init_params
from two_tower_recommender_model.serving import Scorer
from two_tower_recommender_model.serving.batch import batch_predict
from two_tower_recommender_model.serving.server import ModelServer, validate_serving_input


@pytest.fixture(scope="module")
def scorer():
    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8)
    return Scorer(mcfg, init_params(jax.random.key(0), mcfg))


def _post(url, payload):
    req = urllib.request.Request(
        url + "/invocations", json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def test_invocations_inputs_form(scorer, tmp_path):
    cap = str(tmp_path / "capture.jsonl")
    with ModelServer(scorer, capture_path=cap) as srv:
        out = _post(srv.url, {"inputs": {"user_id": [1, 2], "product_id": [3, 4]}})
        assert len(out["predictions"]) == 2
        assert all(0 <= p <= 1 for p in out["predictions"])
        # health
        with urllib.request.urlopen(srv.url + "/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
    with open(cap) as f:
        lines = f.readlines()
    assert len(lines) == 1 and "predictions" in lines[0]


def test_invocations_dataframe_split(scorer):
    with ModelServer(scorer) as srv:
        out = _post(srv.url, {"dataframe_split": {
            "columns": ["user_id", "product_id"], "data": [[1, 3], [2, 4]]}})
        assert len(out["predictions"]) == 2


def test_invocations_dataframe_records(scorer):
    with ModelServer(scorer) as srv:
        out = _post(srv.url, {"dataframe_records": [
            {"user_id": 1, "product_id": 3}, {"user_id": 2, "product_id": 4}]})
        assert len(out["predictions"]) == 2


def test_bad_payload_400(scorer):
    with ModelServer(scorer) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url, {"wrong": 1})
        assert e.value.code == 400


def test_unknown_path_404(scorer):
    with ModelServer(scorer) as srv:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv.url.replace("/invocations", "") + "/nope", {})
            # urllib builds /invocations in _post; hit another path directly:
        req = urllib.request.Request(srv.url + "/elsewhere", b"{}")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 404


def test_validate_serving_input(scorer):
    preds = validate_serving_input(scorer, {"inputs": {"user_id": [5], "product_id": [6]}})
    assert preds.shape == (1,)
    with pytest.raises(ValueError):
        validate_serving_input(scorer, {"nope": {}})


def test_batch_predict_ttrs(scorer, tmp_path, rng):
    n = 500
    write_dataset(str(tmp_path / "in"), {
        "user_id": rng.integers(1, 50, n), "product_id": rng.integers(1, 30, n),
        "label": rng.integers(0, 2, n)}, rows_per_shard=128)
    idx = batch_predict(scorer, str(tmp_path / "in"), str(tmp_path / "out"), batch_size=128)
    assert idx["total_rows"] == n
    out = ShardedDataset(str(tmp_path / "out"))
    preds = np.concatenate([out.read_shard(i)["prediction"] for i in range(out.num_shards)])
    assert preds.shape == (n,) and ((preds >= 0) & (preds <= 1)).all()


def test_retrieve_endpoint(tmp_path, rng):
    from two_tower_recommender_model.serving import RetrievalService
    from two_tower_recommender_model.models.two_tower import init_params
    from two_tower_recommender_model.evaluation.retrieval import export_feature_embeddings

    mcfg = cfg_lib.two_tower_model_config(num_users=50, num_items=30, embedding_dim=8)
    params = init_params(jax.random.key(0), mcfg)
    svc = RetrievalService(mcfg, params)
    scorer = Scorer(mcfg, params)

    # direct call matches brute force
    items, scores = svc.retrieve([1, 7], k=5)
    user_emb = export_feature_embeddings(params, mcfg, "user_id", ids=np.array([1, 7]))
    item_emb = export_feature_embeddings(params, mcfg, "product_id")
    brute = user_emb @ item_emb[1:].T
    want = np.argsort(-brute, axis=1)[:, :5] + 1
    got_scores = np.take_along_axis(brute, items - 1, 1)
    want_scores = np.take_along_axis(brute, want - 1, 1)
    np.testing.assert_allclose(got_scores, want_scores, rtol=1e-5)

    with ModelServer(scorer, retrieval=svc) as srv:
        out = _post_path(srv.url, "/retrieve", {"user_id": [1, 7], "k": 5})
        assert len(out["items"]) == 2 and len(out["items"][0]) == 5
        assert all(1 <= i <= 30 for i in out["items"][0])
        # k out of range -> 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_path(srv.url, "/retrieve", {"user_id": [1], "k": 0})
        assert e.value.code == 400
        # /retrieve 404 when service absent
    with ModelServer(scorer) as srv2:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_path(srv2.url, "/retrieve", {"user_id": [1], "k": 5})
        assert e.value.code == 404


def _post_path(url, path, payload):
    req = urllib.request.Request(
        url + path, json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())
