"""Compact wire format: minimum-byte batches for a wire-bound host->device link.

Motivation: when the host->device link is the bottleneck of the hot loop,
every wire byte is throughput. Whether it binds on a PCIe-attached GPU has
not been measured; the format costs nothing in numerics either way.

`PackedBatch` ships raw int32 ids (4 B/slot) because hashing happens on
device. But the hash is pure and the mask depends only on `raw != 0`, so the
host can pre-hash and ship each slot at its information width instead:

    enc(raw) = 0                         if raw == 0   (missing sentinel)
               (raw % N) + 1             otherwise     (in [1, N])

which needs ceil(log2(N+1)) bits (+1 for the label bit on slot 0 when
`pack_label`). Layout is BYTE-PLANED: each slot ships bits//8 whole planes
of `[B]` uint8 (plane-major: contiguous device slices, and low-entropy
high-order planes sit together — friendlier to wire compression); the
remaining bits%8 bits of every slot are concatenated per example (R bits)
and packed 8 examples -> R bytes in a separate `rem[R, B//8]` buffer, so the
transport is true bit-width. The flagship two-feature model (206,209 users
+ label bit = 19 bits, 49,688 items = 16 bits) drops from 8 B to
4.375 B/example. Requires B % 8 == 0 and 8*R <= 32; the scheme falls back
to whole-byte slots otherwise.

Decode runs inside the consumer jit program (shifts/ors/reshapes — fuses to
~zero cost) and reproduces EXACTLY the `unpack_batch` semantics: same hashed
ids, same `raw != 0` mask, same labels (tested bit-identical).

Reference parity note: the reference ships >= 3 int64/float tensors per
example via torch default collation (`transform_to_torchrec_batch`,
`03_model_training.py:353-380`) — ~24 B/example on the same model.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np

from two_tower_recommender_model.config import ModelConfig
from two_tower_recommender_model.data.device_featurizer import PackedBatch
from two_tower_recommender_model.data.featurizer import Batch, SparseFeature
from two_tower_recommender_model.utils.pytree import pytree_dataclass


@pytree_dataclass
class CompactBatch:
    """Wire-minimal batch. `wire` holds the whole-byte planes; `rem` holds the
    packed remainder bits (8 examples per byte column), absent when every
    slot's width is a byte multiple. `delta_pos`/`delta_extra` carry the rare
    oversized deltas of a delta-encoded sorted slot (see CompactScheme)."""

    wire: jax.Array  # [W8, B] uint8 whole-byte planes
    rem: jax.Array | None  # [R, B//8] uint8 remainder-bit planes (or None)
    labels: jax.Array  # [B] int32, or [0] when the label bit rides in the wire
    dense: jax.Array | None = None
    weights: jax.Array | None = None
    delta_pos: jax.Array | None = None  # [K] int32 positions of deltas > 255
    delta_extra: jax.Array | None = None  # [K] int32 (delta - 255) at those positions

    @property
    def batch_size(self) -> int:
        return self.wire.shape[-1]


@dataclasses.dataclass(frozen=True)
class _SlotPlan:
    feature: str
    sub: int  # sub-slot index within the feature (multi-hot features)
    slot_off: int  # column in PackedBatch.ids_raw
    num_embeddings: int
    bits: int  # total bits incl. label bit when has_label
    bits_id: int  # bits of the id payload (excl. label bit)
    has_label: bool
    byte_start: int  # first whole-byte plane in `wire`
    nbytes: int  # whole-byte planes
    rem_bits: int  # remainder bits in the shared `rem` planes
    rem_off: int  # bit offset of this slot's remainder within the R-bit group
    delta: bool = False  # sorted-slot delta encoding (one uint8 plane)


def _bits_for(n_values: int) -> int:
    return max(1, int(n_values - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class CompactScheme:
    """Static wire layout derived from the model config (all shapes/offsets
    are trace-time constants, so the decode fuses into the consumer jit)."""

    slots: tuple[_SlotPlan, ...]
    pack_label: bool
    whole_bytes: int  # W8
    rem_bits_total: int  # R (remainder bits per example; 0 = no rem buffer)
    delta_feature: str | None = None  # host-sorted slot shipped as uint8 deltas
    delta_capacity: int = 0  # K: static exception-array length (PER SEGMENT)
    # number of independently-sorted contiguous batch segments (1 = the whole
    # batch is one host-sorted stream; H = multi-host, each process sorts and
    # delta-encodes its own slice — the decode cumsum resets at segment
    # boundaries). Segment boundaries must align with the assembled global
    # batch's per-process slices.
    delta_segments: int = 1

    @classmethod
    def from_model(cls, model_cfg: ModelConfig, pack_label: bool = True,
                   bit_pack: bool = True,
                   delta_feature: str | None = None,
                   delta_segments: int = 1) -> "CompactScheme":
        """`bit_pack=False` rounds every slot up to whole bytes (no remainder
        buffer) — for callers that can't guarantee B % 8 == 0.

        `delta_feature` names a single-slot feature whose batches arrive
        HOST-SORTED by its hashed id, missing last (the `sort_feature`
        contract): that slot ships as one uint8 plane of consecutive-id
        DELTAS plus a fixed [K]-exception sidecar for deltas > 255. Since the
        deltas of a sorted sequence sum to <= N+1, at most (N+1)//256
        exceptions can exist, so K is a static guarantee, not a heuristic.
        The flagship 19-bit user slot drops to 9 bits (8 delta + 1 label).

        `delta_segments=H` declares the batch as H per-process-sorted slices
        (multi-host: every host encodes its own slice; positions in the
        exception sidecar are segment-relative). K is then rounded up to a
        multiple of 64 so the assembled [H*K] sidecar divides evenly over
        device meshes."""
        plans: list[_SlotPlan] = []
        byte_cursor = 0
        rem_cursor = 0
        slot_off = 0
        delta_cap = 0
        for fc in model_cfg.features:
            n = model_cfg.feature_table(fc.name).num_embeddings
            is_delta = delta_feature is not None and fc.name == delta_feature
            if is_delta and fc.max_ids_per_sample != 1:
                raise ValueError(
                    f"delta_feature {delta_feature!r} must be single-slot"
                )
            for sub in range(fc.max_ids_per_sample):
                has_label = pack_label and slot_off == 0
                bits_id = _bits_for(n + 1)  # enc values 0..N inclusive
                if is_delta:
                    # one uint8 delta plane; the label bit (if any) moves to
                    # the remainder group as a standalone bit
                    rem = (1 if has_label else 0) if bit_pack else 0
                    nbytes = 1 if bit_pack or not has_label else 2
                    delta_cap = (n + 1) // 256 + 2
                    if delta_segments > 1:
                        delta_cap = -(-delta_cap // 64) * 64
                    plans.append(_SlotPlan(
                        feature=fc.name, sub=sub, slot_off=slot_off,
                        num_embeddings=n, bits=8 + (1 if has_label else 0),
                        bits_id=bits_id, has_label=has_label,
                        byte_start=byte_cursor, nbytes=nbytes,
                        rem_bits=rem, rem_off=rem_cursor, delta=True,
                    ))
                    byte_cursor += nbytes
                    rem_cursor += rem
                    slot_off += 1
                    continue
                bits = bits_id + (1 if has_label else 0)
                if bits > 31:
                    raise ValueError(
                        f"compact: slot {fc.name}[{sub}] needs {bits} bits > 31; "
                        "use the packed wire format for this model"
                    )
                rem = bits % 8 if bit_pack else 0
                nbytes = bits // 8 if bit_pack else (bits + 7) // 8
                plans.append(_SlotPlan(
                    feature=fc.name, sub=sub, slot_off=slot_off,
                    num_embeddings=n, bits=bits, bits_id=bits_id,
                    has_label=has_label, byte_start=byte_cursor, nbytes=nbytes,
                    rem_bits=rem, rem_off=rem_cursor,
                ))
                byte_cursor += nbytes
                rem_cursor += rem
                slot_off += 1
        if delta_feature is not None and not any(sp.delta for sp in plans):
            raise ValueError(f"delta_feature {delta_feature!r}: no such feature")
        if rem_cursor and 8 * rem_cursor > 32:
            # the per-8-example remainder group must fit an int32; fall back
            return cls.from_model(model_cfg, pack_label, bit_pack=False,
                                  delta_feature=delta_feature,
                                  delta_segments=delta_segments)
        return cls(
            slots=tuple(plans),
            pack_label=pack_label,
            whole_bytes=byte_cursor,
            rem_bits_total=rem_cursor,
            delta_feature=delta_feature,
            delta_capacity=delta_cap,
            delta_segments=delta_segments,
        )

    @property
    def wire_bytes_per_example(self) -> float:
        """Asymptotic per-example wire bytes (the fixed [K]-exception sidecar
        of a delta slot — 8*K bytes/batch — amortizes to ~0 at real batch
        sizes and is excluded)."""
        return self.whole_bytes + self.rem_bits_total / 8.0


def compact_from_packed(pb: PackedBatch, scheme: CompactScheme) -> CompactBatch:
    """Host half: PackedBatch -> CompactBatch (vectorized numpy; preserves row
    order, so a `sort_feature`-sorted batch stays sorted)."""
    ids = np.asarray(pb.ids_raw)
    b = ids.shape[0]
    if scheme.rem_bits_total and b % 8:
        raise ValueError(f"compact bit-packing needs batch size % 8 == 0, got {b}")
    wire = np.empty((scheme.whole_bytes, b), np.uint8)
    rem_group = np.zeros((b // 8,), np.int64) if scheme.rem_bits_total else None
    delta_pos = delta_extra = None
    for sp in scheme.slots:
        raw = ids[:, sp.slot_off].astype(np.int64)
        label = None
        if sp.has_label:
            label = (raw >> 30) & 1
            raw = raw & ((1 << 30) - 1)
        v = (raw % sp.num_embeddings) + 1
        v = np.where(raw == 0, 0, v)
        if sp.delta:
            n = sp.num_embeddings
            k = np.where(v == 0, n + 1, v)  # missing sorts/encodes above all ids
            d = np.diff(k, prepend=0)
            if d.min() < 0:
                raise ValueError(
                    f"delta slot {sp.feature!r}: batch is not sorted by its "
                    "hashed id (missing last) — featurize with "
                    f"sort_feature={sp.feature!r}"
                )
            lo = np.minimum(d, 255)
            exc = np.nonzero(d > 255)[0]
            kcap = scheme.delta_capacity
            assert len(exc) <= kcap, (len(exc), kcap)  # sum(d) <= N+1 bound
            delta_pos = np.zeros(kcap, np.int32)
            delta_extra = np.zeros(kcap, np.int32)
            delta_pos[: len(exc)] = exc
            delta_extra[: len(exc)] = (d[exc] - 255).astype(np.int32)
            wire[sp.byte_start] = lo.astype(np.uint8)
            if sp.has_label:
                if sp.rem_bits:  # label bit rides the remainder group
                    lanes = label.reshape(b // 8, 8)
                    shifts = np.arange(8, dtype=np.int64) * scheme.rem_bits_total + sp.rem_off
                    rem_group |= (lanes << shifts[None, :]).sum(axis=1, dtype=np.int64)
                else:  # whole-byte fallback: label in its own plane
                    wire[sp.byte_start + 1] = label.astype(np.uint8)
            continue
        if label is not None:
            v = v | (label << sp.bits_id)
        for j in range(sp.nbytes):
            wire[sp.byte_start + j] = (v >> (8 * j)).astype(np.uint8)
        if sp.rem_bits:
            r = (v >> (8 * sp.nbytes)) & ((1 << sp.rem_bits) - 1)
            lanes = r.reshape(b // 8, 8)
            shifts = np.arange(8, dtype=np.int64) * scheme.rem_bits_total + sp.rem_off
            rem_group |= (lanes << shifts[None, :]).sum(axis=1, dtype=np.int64)
    rem = None
    if rem_group is not None:
        rem = np.empty((scheme.rem_bits_total, b // 8), np.uint8)
        for j in range(scheme.rem_bits_total):
            rem[j] = (rem_group >> (8 * j)).astype(np.uint8)
    return CompactBatch(wire=wire, rem=rem, labels=np.asarray(pb.labels),
                        dense=pb.dense, weights=pb.weights,
                        delta_pos=delta_pos, delta_extra=delta_extra)


def batch_from_compact(cb: CompactBatch, model_cfg: ModelConfig,
                       scheme: CompactScheme) -> Batch:
    """Device half (jit-traceable): byte planes -> hashed ids + masks + labels.
    Bit-identical to `unpack_batch(PackedBatch)` on the same data (tested)."""
    wire = cb.wire
    labels = cb.labels
    b = wire.shape[-1]

    rem_val = rem_lane = None
    if scheme.rem_bits_total:
        g = jnp.zeros((b // 8,), jnp.int32)
        for j in range(scheme.rem_bits_total):
            g = g | (cb.rem[j].astype(jnp.int32) << (8 * j))
        rem_val = jnp.repeat(g, 8)  # [B] — each group value on its 8 lanes
        rem_lane = jax.lax.broadcasted_iota(jnp.int32, (b,), 0) % 8

    per_feature_ids: dict[str, list] = {}
    per_feature_mask: dict[str, list] = {}
    for sp in scheme.slots:
        if sp.delta:
            d = wire[sp.byte_start].astype(jnp.int32)
            s = scheme.delta_segments
            if s > 1:
                # per-process-sorted slices: exception positions are segment-
                # relative ([S*K] assembled sidecar) and the cumsum resets at
                # segment boundaries (reshape keeps it GSPMD-partitionable —
                # segment edges align with per-process batch slices)
                seg = b // s
                kcap = scheme.delta_capacity
                pos = (cb.delta_pos.reshape(s, kcap)
                       + jnp.arange(s, dtype=jnp.int32)[:, None] * seg)
                # padding entries carry extra=0 at each segment's base — a
                # harmless += 0
                d = d.at[pos.reshape(-1)].add(cb.delta_extra, mode="drop")
                k = jnp.cumsum(d.reshape(s, seg), axis=1).reshape(b)
            else:
                d = d.at[cb.delta_pos].add(cb.delta_extra, mode="drop")
                k = jnp.cumsum(d)
            n = sp.num_embeddings
            v = jnp.where(k == n + 1, 0, k)
            if sp.has_label:
                if sp.rem_bits:
                    labels = (rem_val >> (rem_lane * scheme.rem_bits_total + sp.rem_off)) & 1
                else:
                    labels = wire[sp.byte_start + 1].astype(jnp.int32) & 1
            mask = v != 0
            ids = jnp.maximum(v - 1, 0)
            per_feature_ids.setdefault(sp.feature, []).append(ids)
            per_feature_mask.setdefault(sp.feature, []).append(mask)
            continue
        v = jnp.zeros((b,), jnp.int32)
        for j in range(sp.nbytes):
            v = v | (wire[sp.byte_start + j].astype(jnp.int32) << (8 * j))
        if sp.rem_bits:
            r = (rem_val >> (rem_lane * scheme.rem_bits_total + sp.rem_off)) & (
                (1 << sp.rem_bits) - 1
            )
            v = v | (r << (8 * sp.nbytes))
        if sp.has_label:
            labels = (v >> sp.bits_id) & 1
            v = v & ((1 << sp.bits_id) - 1)
        mask = v != 0
        ids = jnp.maximum(v - 1, 0)
        per_feature_ids.setdefault(sp.feature, []).append(ids)
        per_feature_mask.setdefault(sp.feature, []).append(mask)

    feats = {
        name: SparseFeature(
            ids=jnp.stack(cols, axis=1).astype(jnp.int32),
            mask=jnp.stack(per_feature_mask[name], axis=1).astype(jnp.float32),
        )
        for name, cols in per_feature_ids.items()
    }
    return Batch(features=feats, labels=labels, dense=cb.dense, weights=cb.weights)


class CompactFeaturizer:
    """Host featurizer adapter: wraps any featurizer that yields PackedBatch
    (`PackedFeaturizer` online, `PrepackedFeaturizer` from pre-packed shards)
    and re-encodes to the compact wire. Row sorting (`sort_feature`) happens in
    the inner featurizer, before encoding, so the sorted-scatter fast path is
    preserved end to end."""

    def __init__(self, inner, scheme: CompactScheme):
        inner_pl = getattr(inner, "pack_label", None)
        if inner_pl is not None and inner_pl != scheme.pack_label:
            # a mismatch silently corrupts data: scheme.pack_label=False on a
            # label-packed inner hashes raw|1<<30 values; the reverse misreads
            # bit 30 of legal ids >= 2^30 as a label
            raise ValueError(
                f"CompactScheme.pack_label={scheme.pack_label} does not match "
                f"the inner featurizer's pack_label={inner_pl}"
            )
        if scheme.delta_feature is not None:
            inner_sort = getattr(inner, "sort_feature", None)
            if inner_sort != scheme.delta_feature:
                raise ValueError(
                    f"delta_feature {scheme.delta_feature!r} requires the inner "
                    f"featurizer to sort by it (sort_feature={inner_sort!r})"
                )
        self.inner = inner
        self.scheme = scheme

    def __call__(self, columns: Mapping[str, np.ndarray]) -> CompactBatch:
        return compact_from_packed(self.inner(columns), self.scheme)


def make_compact_train_step(train_step, model_cfg: ModelConfig, scheme: CompactScheme):
    """Wrap a (state, Batch) train step to take CompactBatch."""
    import functools

    @functools.wraps(train_step)
    def step(state, cb: CompactBatch):
        return train_step(state, batch_from_compact(cb, model_cfg, scheme))

    return jax.jit(step, donate_argnums=(0,))


def make_compact_eval_step(eval_step, model_cfg: ModelConfig, scheme: CompactScheme):
    @jax.jit
    def step(state, eval_state, cb: CompactBatch):
        return eval_step(state, eval_state, batch_from_compact(cb, model_cfg, scheme))

    return step
