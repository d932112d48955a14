"""Full-corpus embedding export + exact top-k retrieval evaluation.

Replaces the reference's offline serving/eval chain
(`03_model_training.py:1056-1240` + `04_evaluate_retrieval.py`):

- reference: enumerate all ids through a one-hot-keyed KJT
  (`create_keyed_jagged_tensor`, `:1056-1093`), push pooled embeddings through
  the side's projection (`process_embeddings`, `:1095-1122`), write to Delta,
  sync a Vector Search ANN index (`:1189-1211`), then per-user
  `similarity_search(k=100)` over 10k users and
  `mlflow.evaluate(model_type="retriever")` (`04_evaluate_retrieval.py:131-226`).
- here: the corpus embedding and the k-NN search are one chunked matmul
  with a running top-k merge (`ops/topk.py`) — exact, on-device, no service.

Metrics: recall@k (the reference's headline `recall_at_100/score`),
precision@k, NDCG@k, MRR, hit-rate — computed per user then averaged, same
protocol as `mlflow.evaluate(model_type="retriever", retriever_k=k)`.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model.config import ModelConfig
from two_tower_recommender_model.models.mlp import apply_mlp
from two_tower_recommender_model.ops.topk import chunked_topk


def _tower_for_feature(model_cfg: ModelConfig, feature_name: str):
    for key, tower in (("query_tower", model_cfg.query_tower),
                       ("candidate_tower", model_cfg.candidate_tower)):
        if feature_name in tower.features:
            return key, tower
    raise ValueError(f"feature {feature_name!r} feeds no tower")


def export_feature_embeddings(
    params: dict,
    model_cfg: ModelConfig,
    feature_name: str,
    ids: np.ndarray | None = None,
    batch_size: int = 8192,
    dense: np.ndarray | None = None,
) -> np.ndarray:
    """Tower-space embeddings for every id of one feature, all other features
    of that tower pooled to zero (exactly the reference's 0-length-bag trick
    for the non-target key, `03_model_training.py:1068-1093`).

    `dense` ([len(ids), tower.dense_dim]) supplies the tower's dense side
    input per id (e.g. item text-feature vectors); zeros when omitted."""
    tower_key, tower = _tower_for_feature(model_cfg, feature_name)
    fc = model_cfg.feature(feature_name)
    table_cfg = model_cfg.table(fc.table)
    # arrays go in as ARGUMENTS, never closures: a closed-over table would be
    # baked into the lowered program as a literal constant (observed 200s+
    # compiles shipping a 105MB table inside the HLO)
    from two_tower_recommender_model.ops.quantized import QuantizedTable, dequantize_table

    table = params["tables"][fc.table]
    if isinstance(table, QuantizedTable):
        table = dequantize_table(table)  # int8-trained state exports like f32
    table = jnp.asarray(table)
    tower_params = jax.tree.map(jnp.asarray, params[tower_key])
    if ids is None:
        ids = np.arange(table_cfg.num_embeddings)
    # same modulo-hash as the training featurizer — raw ids outside [0, N)
    # must hit the same row they trained on (jnp.take would clamp instead)
    ids = np.asarray(ids) % table_cfg.num_embeddings
    if dense is not None:
        dense = np.asarray(dense, np.float32)
        if dense.shape != (len(ids), tower.dense_dim):
            raise ValueError(
                f"dense {dense.shape} != ({len(ids)}, {tower.dense_dim})"
            )

    bs = min(batch_size, len(ids))
    run_chunk = functools.partial(
        _export_chunk, model_cfg=model_cfg, feature_name=feature_name, tower_key=tower_key
    )
    out = []
    for start in range(0, len(ids), bs):
        chunk = ids[start : start + bs]
        dchunk = None if dense is None else dense[start : start + bs]
        pad = bs - len(chunk)  # pad the tail chunk so one jit compile serves all
        if pad:
            chunk = np.concatenate([chunk, np.zeros(pad, chunk.dtype)])
            if dchunk is not None:
                dchunk = np.concatenate([dchunk, np.zeros((pad, dchunk.shape[1]), dchunk.dtype)])
        emb = np.asarray(run_chunk(
            table, tower_params, jnp.asarray(chunk),
            None if dchunk is None else jnp.asarray(dchunk),
        ))
        out.append(emb[: bs - pad])
    return np.concatenate(out, axis=0)


@functools.partial(jax.jit, static_argnames=("model_cfg", "feature_name", "tower_key"))
def _export_chunk(table, tower_params, chunk_ids, dense, *, model_cfg, feature_name,
                  tower_key):
    # module-level jit: cached across export calls (configs are hashable
    # frozen dataclasses, so they key the cache as static args)
    tower = getattr(model_cfg, tower_key)
    rows = jnp.take(table, chunk_ids, axis=0)
    xs = []
    for f in tower.features:
        if f == feature_name:
            xs.append(rows)
        else:
            dim = model_cfg.feature_table(f).embedding_dim
            xs.append(jnp.zeros((rows.shape[0], dim), rows.dtype))
    if tower.dense_dim:
        xs.append(jnp.zeros((rows.shape[0], tower.dense_dim), rows.dtype)
                  if dense is None else dense.astype(rows.dtype))
    x = jnp.concatenate(xs, axis=1) if len(xs) > 1 else xs[0]
    return apply_mlp(tower_params, x, tower.activation, tower.final_activation,
                     jnp.dtype(model_cfg.compute_dtype))


def retrieval_metrics(
    pred_ids: np.ndarray,  # [U, k] retrieved ids, best first
    targets: list,  # per-user iterable of relevant ids
    ks: tuple[int, ...] = (10, 100),
) -> dict[str, float]:
    """Per-user metrics averaged over users (the `mlflow.evaluate` retriever
    metric set, `04_evaluate_retrieval.py:202-226`)."""
    pred_ids = np.asarray(pred_ids)
    max_k = pred_ids.shape[1]
    out: dict[str, list[float]] = {}
    for k in ks:
        if k > max_k:
            raise ValueError(f"k={k} > retrieved {max_k}")
    for preds, tgt in zip(pred_ids, targets):
        tgt = set(int(t) for t in tgt)
        if not tgt:
            continue
        hits = np.isin(preds, np.fromiter(tgt, dtype=np.int64)).astype(np.float64)
        first_hit = np.argmax(hits) if hits.any() else None
        out.setdefault("mrr", []).append(0.0 if first_hit is None else 1.0 / (first_hit + 1))
        for k in ks:
            h = hits[:k]
            rel = h.sum()
            # mlflow retriever protocol divides by len(targets), NOT
            # min(len(targets), k) — users with more than k held-out positives
            # cannot reach recall 1.0 (`mlflow.evaluate(model_type="retriever")`,
            # `04_evaluate_retrieval.py:202-210`)
            out.setdefault(f"recall_at_{k}", []).append(rel / len(tgt))
            out.setdefault(f"precision_at_{k}", []).append(rel / k)
            out.setdefault(f"hit_rate_at_{k}", []).append(1.0 if rel > 0 else 0.0)
            dcg = (h / np.log2(np.arange(2, k + 2))).sum()
            ideal = (1.0 / np.log2(np.arange(2, min(len(tgt), k) + 2))).sum()
            out.setdefault(f"ndcg_at_{k}", []).append(dcg / ideal if ideal > 0 else 0.0)
    return {name: float(np.mean(vals)) for name, vals in out.items()}


def split_positives(
    split_path: str,
    user_col: str = "user_id",
    item_col: str = "product_id",
    label_col: str = "label",
) -> dict[int, list]:
    """Held-out positives grouped per user from a TTRS split directory — the
    eval-set builder of `04_evaluate_retrieval.py:42-58`. Handles both raw-
    column and pre-packed splits (the shared protocol of the CLI evaluator
    and the tuning sweeps; keep ONE implementation so they cannot drift)."""
    from two_tower_recommender_model.data.loader import StreamLoader
    from two_tower_recommender_model.data.shards import ShardedDataset

    dataset = ShardedDataset(split_path)
    packed_meta = dataset.index.get("packed")
    if packed_meta:
        # resolve the feature -> slot mapping from the dataset's RECORDED
        # layout (never assume user/item live at slots 0/1: multi-slot
        # features or a different feature order shift them)
        slot_of, off = {}, 0
        for name, L, _n in packed_meta["slots"]:
            slot_of[name] = off
            off += L
        if user_col not in slot_of or item_col not in slot_of:
            raise ValueError(
                f"packed split {split_path}: features {list(slot_of)} do not "
                f"include {user_col!r}/{item_col!r}"
            )
        u_slot, i_slot = slot_of[user_col], slot_of[item_col]
    columns = None if packed_meta else [user_col, item_col, label_col]
    user_positives: dict[int, list] = {}
    loader = StreamLoader(dataset, 1 << 16, shuffle=False, drop_last=False,
                          columns=columns)
    for cols in loader:
        if packed_meta:
            ids = np.asarray(cols["packed_ids"])
            us = ids[:, u_slot]
            if packed_meta["pack_label"]:
                # the label bit rides bit 30 of slot 0
                labels = (ids[:, 0] >> 30) & 1
                if u_slot == 0:
                    us = us & ((1 << 30) - 1)
            else:
                labels = np.asarray(cols["labels"])
            ps = ids[:, i_slot]
            if packed_meta["pack_label"] and i_slot == 0:
                ps = ps & ((1 << 30) - 1)
        else:
            labels = np.asarray(cols[label_col])
            us, ps = np.asarray(cols[user_col]), np.asarray(cols[item_col])
        m = labels == 1
        for u, p in zip(us[m], ps[m]):
            user_positives.setdefault(int(u), []).append(int(p))
    return user_positives


def evaluate_retrieval(
    params: dict,
    model_cfg: ModelConfig,
    user_positives: dict[int, list],  # user id -> held-out relevant item ids
    query_feature: str = "user_id",
    candidate_feature: str = "product_id",
    k: int = 100,
    max_users: int = 10_000,
    ks: tuple[int, ...] = (10, 100),
    exclude_item_zero: bool = True,
    query_dense: np.ndarray | None = None,  # [num_query_ids_total, Dq] per raw id
    candidate_dense: np.ndarray | None = None,  # [num_items, Dc] per raw id
) -> dict[str, float]:
    """The full `04_evaluate_retrieval.py` protocol: held-out positives per
    user (`:42-58`), top-k search per user (k=100 over <=10k users, `:131-141`),
    averaged retriever metrics (`:202-226`). `candidate_dense`/`query_dense`
    supply per-id dense tower inputs (e.g. item text features) indexed by raw
    id."""
    if not user_positives:
        raise ValueError(
            "user_positives is empty — the split has no label==1 rows to "
            "evaluate against (check the split / label column)"
        )
    users = np.array(sorted(user_positives.keys())[:max_users])
    user_emb = export_feature_embeddings(
        params, model_cfg, query_feature, ids=users,
        dense=None if query_dense is None else np.asarray(query_dense)[users],
    )
    item_emb = export_feature_embeddings(
        params, model_cfg, candidate_feature, dense=candidate_dense,
    )
    start = 1 if exclude_item_zero else 0  # id 0 = missing sentinel
    corpus = jnp.asarray(item_emb[start:])
    _, idx = chunked_topk(jnp.asarray(user_emb), corpus, k=k)
    pred_ids = np.asarray(idx) + start
    metrics = retrieval_metrics(pred_ids, [user_positives[u] for u in users], ks=ks)
    metrics["num_users"] = float(len(users))
    return metrics


def make_retrieval_eval_fn(
    model_cfg: ModelConfig,
    user_positives: dict[int, list],
    query_feature: str = "user_id",
    candidate_feature: str = "product_id",
    k: int = 100,
    ks: tuple[int, ...] = (100,),
    max_users: int = 2_000,
    metric_prefix: str = "val_",
    params_fn=None,
    **eval_kwargs,
):
    """Per-epoch retrieval-metric hook for `train_val_test(retrieval_eval_fn=
    ...)`: `fn(state) -> {"val_recall_at_100": ...}` via the exact top-k on a
    user subsample (seconds at val scale — exact sharded top-k is cheap).

    This exists because val AUROC is NOT a stopping/selection signal for the
    in-batch sampled-softmax objective — measured at full scale, AUROC
    declines while retrieval recall holds; the
    reference's own headline metric is recall@k
    (`04_evaluate_retrieval.py:202-226`). `select_best="val_recall_at_100"`
    then keeps the epoch that actually retrieves best.

    `params_fn(state) -> params` overrides the default `full_params` (e.g.
    `unshard_train_state` composition for sharded states)."""

    def fn(state) -> dict[str, float]:
        if params_fn is not None:
            params = params_fn(state)
        else:
            from two_tower_recommender_model.train.step import full_params

            params = full_params(state)
        m = evaluate_retrieval(
            params, model_cfg, user_positives,
            query_feature=query_feature, candidate_feature=candidate_feature,
            k=k, max_users=max_users, ks=ks, **eval_kwargs,
        )
        return {f"{metric_prefix}{name}": v for name, v in m.items()}

    return fn


def per_user_retrieval_table(
    pred_ids: np.ndarray, users: np.ndarray, targets: list, ks: tuple[int, ...] = (100,)
):
    """Per-user eval table (the reference's per-user results DataFrame,
    `04_evaluate_retrieval.py:221-226`): one row per user with targets,
    predictions and per-user metrics."""
    import pandas as pd

    rows = []
    for u, preds, tgt in zip(users, np.asarray(pred_ids), targets):
        m = retrieval_metrics(preds[None, :], [tgt], ks=ks)
        rows.append({
            "user_id": u,
            "product_id_list": list(map(int, tgt)),
            "product_id_pred": [int(p) for p in preds],
            **m,
        })
    return pd.DataFrame(rows)
