"""Make `two_tower_recommender_model` importable when the editable install
is absent (fresh shells / CI): scripts run as `python scripts/x.py` get only
`scripts/` on sys.path, so fall back to the repo root (this file's parent's
parent). Import side effect only; no exports."""

import importlib.util
import os
import sys

if importlib.util.find_spec("two_tower_recommender_model") is None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
