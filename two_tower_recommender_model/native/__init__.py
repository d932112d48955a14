"""Native (C++) components, loaded via ctypes.

`load_ttrs_reader()` builds/loads the shard-reader shared library; callers
fall back to the pure-Python path when unavailable (no hard native dep).
"""

from two_tower_recommender_model.native.build import load_ttrs_reader  # noqa: F401
from two_tower_recommender_model.native.ttrs import NativeShardReader, native_read_shard  # noqa: F401
