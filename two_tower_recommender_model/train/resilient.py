"""Failure-resilient training: checkpoint-backed auto-restart.

The reference's failure story is "treat crashes as transient and re-run the
cell" (`03_model_training.py:910-912`; SURVEY §5 'failure detection: none').
Here the same run-to-completion contract is automated: `resilient_fit` runs a
training callable, and on a transient failure restores the latest checkpoint
(model + optimizer + loader position) and continues, up to `max_restarts`.

The training callable owns what "one attempt" means (typically
`train_val_test` with a checkpoint_fn); `resilient_fit` owns the
restore-and-retry policy. Failures during restore are fatal (state may be
corrupt); failures with no checkpoint yet restart from scratch.

What counts as transient: by default only error classes a restart can
plausibly cure — IO/network (`OSError` and subclasses: `ConnectionError`,
filesystem hiccups), `TimeoutError`, and the XLA runtime's
`jax.errors.JaxRuntimeError` (device resets, RPC failures,
preemptions surface here). Programming bugs (`ValueError`, `TypeError`,
assertion failures, shape errors) re-raise IMMEDIATELY — silently
"recovering" from a bug `max_restarts` times just hides it behind minutes
of backoff. Pass `retry_on=(Exception,)` to opt into the old
retry-everything behavior when babysitting a long unattended run.
"""

from __future__ import annotations

import logging
import time
import traceback
from typing import Callable

log = logging.getLogger(__name__)


class TrainingFailure(RuntimeError):
    """Raised by resilient_fit when max_restarts is exhausted."""


def transient_error_types() -> tuple[type[BaseException], ...]:
    """Error classes a checkpoint-restore restart can plausibly cure.

    `OSError` covers IO and network (ConnectionError, shard-read failures);
    `jax.errors.JaxRuntimeError` is where the XLA runtime surfaces device
    loss, RPC failures, and preemption.
    """
    types: list[type[BaseException]] = [OSError, TimeoutError]
    try:
        from jax.errors import JaxRuntimeError

        types.append(JaxRuntimeError)
    except ImportError:  # pragma: no cover - depends on jax version
        pass
    return tuple(types)


def resilient_fit(
    attempt: Callable[[int], dict],
    max_restarts: int = 3,
    retry_on: tuple[type[BaseException], ...] | None = None,
    backoff_s: float = 1.0,
) -> dict:
    """Run `attempt(restart_index)` until it returns; restart on failure.

    `attempt` must be resumable: it should restore from its own checkpoint
    store when one exists (see `scripts/train.py --resume` for the pattern).
    Only `retry_on` errors restart (default: `transient_error_types()` —
    IO/RPC/XLA-runtime); anything else propagates on the first raise.
    Returns the attempt's result dict, augmented with restart accounting.
    """
    if retry_on is None:
        retry_on = transient_error_types()
    failures: list[str] = []
    for restart in range(max_restarts + 1):
        try:
            result = dict(attempt(restart))
            result["restarts"] = restart
            result["failures"] = failures
            return result
        except retry_on as e:  # noqa: PERF203
            failures.append(f"{type(e).__name__}: {e}")
            # full traceback at warning level: after the retry only the
            # message string survives in `failures`, and a transient that
            # keeps recurring needs its stack to be diagnosable from logs
            log.warning(
                "training attempt %d failed; restarting\n%s",
                restart,
                traceback.format_exc(),
            )
            if restart == max_restarts:
                raise TrainingFailure(
                    f"training failed after {max_restarts} restarts: {failures}"
                ) from e
            time.sleep(backoff_s * (restart + 1))
    raise AssertionError("unreachable")
