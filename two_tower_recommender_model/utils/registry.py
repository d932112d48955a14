"""Model registry: named models, immutable numbered versions, stage labels.

The Unity-Catalog MLflow registry role (`mlflow.register_model` +
stage/alias management, reference `pytorch-model-training.py:924`, `:998`;
`workshop/02-mosaic-model-training.py:1258-1322`): a registered model is a
directory of numbered versions, each an `export_model` artifact plus
metadata (source run, stage, description). Stages follow the MLflow
lifecycle: "None" -> "Staging" -> "Production" -> "Archived"; promoting a
version to Production archives the previous Production holder (MLflow's
`transition_model_version_stage(..., archive_existing_versions=True)`).

Layout:

    registry_root/
      <model_name>/
        versions.json              # [{version, stage, run_id, created, ...}]
        v<EX>/                     # export_model dir (config + params)
"""

from __future__ import annotations

import contextlib
import datetime
import fcntl
import json
import os
import shutil


STAGES = ("None", "Staging", "Production", "Archived")


class ModelRegistry:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    # -- write side --------------------------------------------------------

    def register(
        self,
        name: str,
        model_cfg,
        state,
        run_id: str | None = None,
        description: str = "",
        metrics: dict | None = None,
    ) -> int:
        """Register a new numbered version from a TrainState (or any state
        `export_model` accepts). Returns the version number."""
        from two_tower_recommender_model.utils.checkpoint import export_model

        model_dir = os.path.join(self.root, name)
        os.makedirs(model_dir, exist_ok=True)
        # atomic version allocation: os.mkdir either claims the number or
        # fails — a crashed/concurrent register can never reuse or overwrite
        # an existing version directory (numbers may skip past orphans of
        # crashed attempts, which is the immutability-preserving outcome)
        v = (max((e["version"] for e in self._versions(name)), default=0)) + 1
        while True:
            try:
                os.mkdir(os.path.join(model_dir, f"v{v}"))
                break
            except FileExistsError:
                v += 1
        export_model(os.path.join(model_dir, f"v{v}"), model_cfg, state)
        entry = {
            "version": v,
            "stage": "None",
            "run_id": run_id,
            "description": description,
            "metrics": metrics or {},
            "created": datetime.datetime.now(datetime.timezone.utc).isoformat(),
        }
        with self._lock(name):
            versions = self._versions(name)
            versions.append(entry)
            self._write(name, versions)
        return v

    def set_stage(self, name: str, version: int, stage: str,
                  archive_existing: bool = True) -> None:
        """Transition a version's stage; promoting to Production archives the
        current Production version (the MLflow default workflow)."""
        if stage not in STAGES:
            raise ValueError(f"stage {stage!r} not in {STAGES}")
        with self._lock(name):
            versions = self._versions(name)
            entry = self._entry(versions, name, version)
            if stage == "Production" and archive_existing:
                for e in versions:
                    if e["stage"] == "Production" and e["version"] != version:
                        e["stage"] = "Archived"
            entry["stage"] = stage
            self._write(name, versions)

    def delete_version(self, name: str, version: int) -> None:
        with self._lock(name):
            versions = self._versions(name)
            entry = self._entry(versions, name, version)
            shutil.rmtree(os.path.join(self.root, name, f"v{version}"), ignore_errors=True)
            versions.remove(entry)
            self._write(name, versions)

    # -- read side ---------------------------------------------------------

    def list_models(self) -> list[str]:
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.isfile(os.path.join(self.root, d, "versions.json"))
        )

    def versions(self, name: str) -> list[dict]:
        return self._versions(name)

    def get_version(self, name: str, version: int | str = "latest") -> dict:
        """Resolve a version selector: a number, "latest", or a stage name
        (the `models:/<name>/Production` URI role)."""
        versions = self._versions(name)
        if not versions:
            raise FileNotFoundError(f"model {name!r} has no versions")
        if version == "latest":
            return max(versions, key=lambda e: e["version"])
        if isinstance(version, str) and version in STAGES:
            staged = [e for e in versions if e["stage"] == version]
            if not staged:
                raise FileNotFoundError(f"model {name!r} has no {version} version")
            return max(staged, key=lambda e: e["version"])
        return self._entry(versions, name, int(version))

    def model_dir(self, name: str, version: int | str = "latest") -> str:
        return os.path.join(self.root, name, f"v{self.get_version(name, version)['version']}")

    def load(self, name: str, version: int | str = "latest"):
        """(model_cfg, params) for a version — `get_mlflow_model` role
        (`03_model_training.py:1015-1054`)."""
        from two_tower_recommender_model.utils.checkpoint import load_model

        return load_model(self.model_dir(name, version))

    # -- internals ---------------------------------------------------------

    def _versions_path(self, name: str) -> str:
        return os.path.join(self.root, name, "versions.json")

    def _versions(self, name: str) -> list[dict]:
        p = self._versions_path(name)
        if not os.path.exists(p):
            return []
        with open(p) as f:
            return json.load(f)

    def _write(self, name: str, versions: list[dict]) -> None:
        tmp = f"{self._versions_path(name)}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(versions, f, indent=1)
        os.replace(tmp, self._versions_path(name))

    @contextlib.contextmanager
    def _lock(self, name: str):
        """flock-guarded read-modify-write of versions.json (concurrent
        registers on one host must not drop each other's index entries)."""
        path = os.path.join(self.root, name, ".versions.lock")
        with open(path, "w") as f:
            fcntl.flock(f, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(f, fcntl.LOCK_UN)

    def _entry(self, versions: list[dict], name: str, version: int) -> dict:
        for e in versions:
            if e["version"] == version:
                return e
        raise FileNotFoundError(f"model {name!r} has no version {version}")


def register_from_run(
    registry: ModelRegistry, name: str, logger, model_cfg, state, **kw
) -> int:
    """Register straight out of an ExperimentLogger run, carrying the run id
    and its latest metrics (the log-then-register notebook flow,
    `workshop/02-mosaic-model-training.py:1258-1322`)."""
    metrics = logger.metrics()
    latest = metrics[-1] if metrics else {}
    return registry.register(
        name, model_cfg, state, run_id=logger.run_id,
        metrics={k: v for k, v in latest.items() if isinstance(v, (int, float))},
        **kw,
    )
