# Frozen copy of ffvvc_tpu_torch/utils/bufpool.py at commit e2f5d5b, part of the
# benchmark's reference (see __init__.py).  Changes: none (moved to the package root).
"""Per-process pools of per-frame resources (FrameTabs / FrameBuffer).

On this kernel, first-touch page faults on fresh mmap'd allocations cost
~10-15us/page, so the ~40MB of dense per-frame planes a 1080p frame needs
would spend tens of ms faulting every frame (the same finding that led to
the parse record-arena pool, native/parse.py).  Pooling keeps the pages
mapped; a reset fill on warm pages runs at memset speed instead.

Objects are pooled whole (keyed by geometry) and reset in place by their
owners' `_reset()`; the pool itself is type-agnostic.  Thread-safe: the
frame pipeline releases from its worker thread while the main thread
acquires (decoder.py), and decode_parallel forks inherit an empty pool.
"""
import threading

_LOCK = threading.Lock()
_POOL = {}              # key -> [objects]
_MAX_PER_KEY = 24       # > max DPB depth + pipeline in-flight frames


def acquire(key):
    """Pop a pooled object for `key`, or None if the pool is empty."""
    with _LOCK:
        items = _POOL.get(key)
        if items:
            return items.pop()
    return None


def release(obj, key):
    """Return an object to the pool (dropped when the key is full)."""
    with _LOCK:
        items = _POOL.setdefault(key, [])
        if len(items) < _MAX_PER_KEY:
            items.append(obj)


def clear():
    with _LOCK:
        _POOL.clear()
