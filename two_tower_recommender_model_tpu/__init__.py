"""The package's former name, kept as an alias so that existing imports keep
working: importing this package, or any module under it, returns the module
of the same path under `two_tower_recommender_model`, the very same object
(so classes, pytree registrations and isinstance checks are shared)."""

import importlib
import importlib.abc
import importlib.util
import sys

import two_tower_recommender_model as _package

_OLD, _NEW = __name__, _package.__name__


class _AliasFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves `<old>.x.y` to the already-importable `<new>.x.y`."""

    def __init__(self):
        self._specs = {}

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_OLD + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(_NEW + spec.name[len(_OLD):])
        self._specs[spec.name] = module.__spec__
        return module

    def exec_module(self, module):
        # the import system stamped the alias spec on the shared module
        module.__spec__ = self._specs.pop(module.__spec__.name)


sys.meta_path.insert(0, _AliasFinder())
sys.modules[_OLD] = _package
