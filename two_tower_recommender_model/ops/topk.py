"""Exact chunked matmul top-k retrieval.

The on-device replacement for the reference's external ANN service
(Databricks Vector Search `similarity_search`, `03_model_training.py:1189-1211`,
`04_evaluate_retrieval.py:131-141`) — exact instead of approximate, which also
upgrades eval fidelity (SURVEY §2.8.6).

Design: scores are a `[Q, I]` matmul that never materializes. The corpus is
scanned in fixed-size chunks; a running top-k is merged per chunk with
`lax.top_k` over `[Qc, k + chunk]`. Query side is chunked by the caller (or via
`chunked_topk`'s `query_chunk`) so on-chip memory pressure stays bounded. Everything is
static-shaped and jit-compatible; the corpus axis may be sharded (see
`parallel/sharded.py: sharded_topk`) with a cross-shard merge.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _topk_merge_scan(
    queries: jax.Array, corpus: jax.Array, k: int, corpus_chunk: int, valid: int
):
    """Running top-k of queries @ corpus.T over corpus chunks. corpus size must
    be a multiple of corpus_chunk; rows at index >= valid are padding and are
    masked to -inf *before* the merge so they can never evict real entries."""
    num_chunks = corpus.shape[0] // corpus_chunk
    corpus_chunks = corpus.reshape(num_chunks, corpus_chunk, corpus.shape[1])

    q = queries.shape[0]
    init_vals = jnp.full((q, k), -jnp.inf, dtype=jnp.float32)
    init_idx = jnp.zeros((q, k), dtype=jnp.int32)

    def step(carry, xs):
        top_vals, top_idx = carry
        chunk_i, chunk = xs
        scores = jnp.dot(queries, chunk.T, preferred_element_type=jnp.float32)
        cand_idx = chunk_i * corpus_chunk + jax.lax.broadcasted_iota(
            jnp.int32, scores.shape, 1
        )
        scores = jnp.where(cand_idx < valid, scores, -jnp.inf)
        all_vals = jnp.concatenate([top_vals, scores], axis=1)
        all_idx = jnp.concatenate([top_idx, cand_idx], axis=1)
        new_vals, pos = jax.lax.top_k(all_vals, k)
        new_idx = jnp.take_along_axis(all_idx, pos, axis=1)
        return (new_vals, new_idx), None

    (vals, idx), _ = jax.lax.scan(
        step, (init_vals, init_idx), (jnp.arange(num_chunks, dtype=jnp.int32), corpus_chunks)
    )
    return vals, idx


@functools.partial(jax.jit, static_argnames=("k", "corpus_chunk", "query_chunk"))
def chunked_topk(
    queries: jax.Array,  # [Q, D]
    corpus: jax.Array,  # [I, D]
    k: int = 100,
    corpus_chunk: int = 4096,
    query_chunk: int = 1024,
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k dot-product retrieval. Returns (scores [Q, k], indices [Q, k])
    with indices into `corpus` rows, sorted descending by score."""
    qn, d = queries.shape
    corpus_chunk = min(corpus_chunk, max(128, corpus.shape[0]))
    # Pad the corpus to a chunk multiple with -inf-scoring sentinel rows.
    ipad = (-corpus.shape[0]) % corpus_chunk
    if ipad:
        corpus = jnp.concatenate(
            [corpus, jnp.zeros((ipad, d), corpus.dtype)], axis=0
        )
    valid = corpus.shape[0] - ipad

    query_chunk = min(query_chunk, max(1, qn))
    qpad = (-qn) % query_chunk
    if qpad:
        queries = jnp.concatenate([queries, jnp.zeros((qpad, d), queries.dtype)], axis=0)
    qchunks = queries.reshape(-1, query_chunk, d)

    def per_chunk(qc):
        return _topk_merge_scan(qc, corpus, k, corpus_chunk, valid)

    vals, idx = jax.lax.map(per_chunk, qchunks)
    vals = vals.reshape(-1, k)[:qn]
    idx = idx.reshape(-1, k)[:qn]
    return vals, idx
