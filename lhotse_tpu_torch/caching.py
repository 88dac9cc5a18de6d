"""
Global caching switch and in-memory LRU caches of audio (copied from
``lhotse_tpu/caching.py``): ``AudioCache`` holds encoded bytes keyed by
source, ``DecodedAudioCache`` decoded float32 windows; both follow
``set_caching_enabled``.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from functools import lru_cache, wraps
from typing import Any, Callable, Dict, Optional

LHOTSE_CACHING_ENABLED = False

# Registry of every dynamically-cached method: "cached" maps the qualified
# name to the LRU-wrapped callable, "noncached" to the original. Clearing
# happens through the "cached" view.
LHOTSE_CACHED_METHOD_REGISTRY: Dict[str, Dict[str, Any]] = {
    "cached": {},
    "noncached": {},
}
# Alias used throughout this module for the clearable view.
LHOTSE_DYNAMIC_CACHES: Dict[str, Any] = LHOTSE_CACHED_METHOD_REGISTRY["cached"]


def set_caching_enabled(enabled: bool) -> None:
    global LHOTSE_CACHING_ENABLED
    assert isinstance(enabled, bool)
    LHOTSE_CACHING_ENABLED = enabled
    if not enabled:
        for cache in LHOTSE_DYNAMIC_CACHES.values():
            cache.cache_clear()
        AudioCache.clear()
        DecodedAudioCache.clear()


def is_caching_enabled() -> bool:
    return LHOTSE_CACHING_ENABLED


def dynamic_lru_cache(method: Callable) -> Callable:
    """
    Least-recently-used cache decorator that is dynamically enabled/disabled
    via the global caching switch (reference: caching.py:34).
    """
    name = f"{method.__module__}.{method.__qualname__}"
    cached = lru_cache(maxsize=512)(method)
    LHOTSE_DYNAMIC_CACHES[name] = cached
    LHOTSE_CACHED_METHOD_REGISTRY["noncached"][name] = method

    @wraps(method)
    def wrapper(*args, **kwargs):
        if is_caching_enabled():
            return cached(*args, **kwargs)
        return method(*args, **kwargs)

    wrapper.cache_clear = cached.cache_clear  # type: ignore[attr-defined]
    return wrapper


class AudioCache:
    """
    In-memory LRU cache for encoded audio bytes, keyed by the source identifier
    (URL or shell command). Capped at ``AudioCache.max_cache_memory`` bytes;
    inserting beyond the cap evicts least-recently-used entries
    (reference: caching.py:80-178). Thread-safe.
    """

    max_cache_memory: int = 500 * 1024 * 1024
    __cache_dict: "OrderedDict[str, bytes]" = OrderedDict()
    __cache_memory: int = 0
    __lock = threading.Lock()

    @classmethod
    def enabled(cls) -> bool:
        return is_caching_enabled()

    @classmethod
    def enable(cls, enabled: bool = True) -> None:
        """Toggle audio caching; disabling clears the cache (parity:
        reference ``caching.py:106`` — there a class-local flag, here routed
        through the global caching toggle this class already mirrors)."""
        set_caching_enabled(enabled)
        if not enabled:
            cls.clear()

    @classmethod
    def try_cache(cls, key: str) -> Optional[bytes]:
        if not cls.enabled():
            return None
        with cls.__lock:
            if key in cls.__cache_dict:
                cls.__cache_dict.move_to_end(key)
                return cls.__cache_dict[key]
            return None

    @classmethod
    def add_to_cache(cls, key: str, value: bytes) -> None:
        if not cls.enabled():
            return
        if len(value) > cls.max_cache_memory:
            return
        with cls.__lock:
            if key in cls.__cache_dict:
                cls.__cache_dict.move_to_end(key)
                return
            while cls.__cache_memory + len(value) > cls.max_cache_memory and cls.__cache_dict:
                _, evicted = cls.__cache_dict.popitem(last=False)
                cls.__cache_memory -= len(evicted)
            cls.__cache_dict[key] = value
            cls.__cache_memory += len(value)

    @classmethod
    def clear(cls) -> None:
        with cls.__lock:
            cls.__cache_dict.clear()
            cls.__cache_memory = 0

    @classmethod
    def memory_used(cls) -> int:
        return cls.__cache_memory


class DecodedAudioCache:
    """
    In-memory LRU cache of *decoded* audio (float32 arrays + sampling rate),
    keyed by audio-source identity. Complements :class:`AudioCache` (which
    caches encoded bytes): repeatedly-loaded short assets — MUSAN-style
    noise pools, RIR recordings, mixing sources — skip the decoder entirely.

    Only short sources are cached (``max_item_samples`` per channel) so a
    long recording never gets fully decoded just to serve a window. Follows
    the global caching switch; capped at ``max_cache_memory`` bytes with LRU
    eviction. Thread-safe.
    """

    # Decoded floats are 4 B/sample; 1 GiB holds ~4.5 h of 16 kHz mono —
    # sized for data-pipeline hosts (typically tens of GB of RAM), and it
    # now also carries post-transform windows (Recording.load_audio
    # memoization), not just noise/RIR assets. Class attribute: shrink it
    # on small hosts.
    max_cache_memory: int = 1024 * 1024 * 1024
    # ~125 s @ 16 kHz per channel: covers noise/RIR assets, excludes
    # long-form recordings.
    max_item_samples: int = 2_000_000
    # Bound on the first-sighting probation set (keys are small tuples).
    max_probation_keys: int = 100_000
    __cache_dict: "OrderedDict[Any, tuple]" = OrderedDict()
    __cache_memory: int = 0
    __probation: "OrderedDict[Any, None]" = OrderedDict()
    __lock = threading.Lock()

    @classmethod
    def enabled(cls) -> bool:
        return is_caching_enabled()

    @classmethod
    def worth_caching(cls, key) -> bool:
        """
        Cache-on-second-access probation: the first sighting of a key
        registers it and returns False (a one-shot recording should be
        window-decoded directly — full decode + copies would only cost);
        any later sighting returns True (the source is being reused — a
        noise/RIR-pool access pattern — so the full decode pays for itself).
        """
        with cls.__lock:
            if key in cls.__probation:
                return True
            cls.__probation[key] = None
            while len(cls.__probation) > cls.max_probation_keys:
                cls.__probation.popitem(last=False)
            return False

    @classmethod
    def try_cache(cls, key) -> Optional[tuple]:
        """Return the cached ``(samples, sampling_rate)`` or None."""
        if not cls.enabled():
            return None
        with cls.__lock:
            entry = cls.__cache_dict.get(key)
            if entry is not None:
                cls.__cache_dict.move_to_end(key)
            return entry

    @classmethod
    def add_to_cache(cls, key, samples, sampling_rate: int) -> None:
        if not cls.enabled():
            return
        nbytes = samples.nbytes
        if nbytes > cls.max_cache_memory:
            return
        samples = samples.copy()  # detach from caller-visible buffers
        samples.setflags(write=False)
        with cls.__lock:
            if key in cls.__cache_dict:
                cls.__cache_dict.move_to_end(key)
                return
            while cls.__cache_memory + nbytes > cls.max_cache_memory and cls.__cache_dict:
                _, (evicted, _) = cls.__cache_dict.popitem(last=False)
                cls.__cache_memory -= evicted.nbytes
            cls.__cache_dict[key] = (samples, sampling_rate)
            cls.__cache_memory += nbytes

    @classmethod
    def clear(cls) -> None:
        with cls.__lock:
            cls.__cache_dict.clear()
            cls.__probation.clear()
            cls.__cache_memory = 0

    @classmethod
    def memory_used(cls) -> int:
        return cls.__cache_memory
