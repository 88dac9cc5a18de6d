"""
Host helpers of the data path (copied from ``lhotse_tpu/utils/core.py``):
time/sample/frame arithmetic, dataclass helpers and seeding. Only the
helpers the ported host modules call are here; each body is the original's.
"""
from __future__ import annotations

import math
import random
import sys
import uuid
from contextlib import contextmanager
from dataclasses import dataclass, fields
from decimal import ROUND_HALF_DOWN, ROUND_HALF_UP, Decimal
from functools import lru_cache
from math import isclose
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, TypeVar, Union

import numpy as np

Pathlike = Union[Path, str]
T = TypeVar("T")

Seconds = float
Decibels = float
Channels = Union[int, List[int]]

EPSILON = 1e-10
LOG_EPSILON = math.log(EPSILON)
DEFAULT_PADDING_VALUE = 0  # used for custom attrs

# Deterministic uuid generator, installed by fix_random_seed().
_lhotse_uuid: Optional[Callable] = None


def fix_random_seed(random_seed: int):
    """
    Set the same random seed for all the libraries this framework interacts with:
    the ``random`` module, numpy, and the ``uuid4()`` function defined here.

    Unlike the reference (utils.py:141), torch is seeded only if it is already
    imported: the compute path here is JAX, which uses explicit PRNG keys instead
    of global seeding.
    """
    global _lhotse_uuid
    random.seed(random_seed)
    np.random.seed(random_seed)
    if "torch" in sys.modules:
        sys.modules["torch"].random.manual_seed(random_seed)
    rd = random.Random()
    rd.seed(random_seed)
    _lhotse_uuid = lambda: uuid.UUID(int=rd.getrandbits(128))


def uuid4():
    """
    Generates uuid4's exactly like Python's uuid.uuid4() function.
    When ``fix_random_seed()`` is called, it will instead generate deterministic IDs.
    """
    if _lhotse_uuid is not None:
        return _lhotse_uuid()
    return uuid.uuid4()


def asdict_nonull(dclass) -> Dict[str, Any]:
    """
    Recursively convert a dataclass into a dict, removing all fields whose value
    is None (reference: utils.py:167). Keeps key order = dataclass field order,
    which is part of the bitwise-stable manifest contract.
    """

    def non_null_dict_factory(collection):
        d = dict(collection)
        for key in [k for k, v in d.items() if v is None]:
            del d[key]
        return d

    from dataclasses import asdict

    return asdict(dclass, dict_factory=non_null_dict_factory)


def fastcopy(dataclass_obj: T, **kwargs) -> T:
    """
    Returns a new dataclass instance with the same member values,
    selected members overwritten with kwargs (reference: utils.py:274).
    """
    init_values = {
        field.name: getattr(dataclass_obj, field.name)
        for field in fields(dataclass_obj)
        if field.init
    }
    return type(dataclass_obj)(**{**init_values, **kwargs})


def ifnone(item: Optional[T], alt_item: T) -> T:
    """Return ``item`` if it is not None, otherwise ``alt_item``."""
    return alt_item if item is None else item


def exactly_one_not_null(*args) -> bool:
    not_null = [arg is not None for arg in args]
    return sum(not_null) == 1


def split_sequence(
    seq: Iterable[Any], num_splits: int, shuffle: bool = False, drop_last: bool = False,
) -> List[List[Any]]:
    """
    Split an iterable into ``num_splits`` even chunks; with ``drop_last=False``
    the remainder is distributed one-per-chunk from the front
    (reference: utils.py:340-408 index-shift scheme).
    """
    seq = list(seq)
    num_items = len(seq)
    if num_splits > num_items:
        raise ValueError(
            f"Cannot split iterable into more chunks ({num_splits}) than its number of items {num_items}"
        )
    if shuffle:
        random.shuffle(seq)
    chunk_size = num_items // num_splits
    num_shifts = num_items % num_splits
    if drop_last:
        end_shifts = [0] * num_splits
        begin_shifts = [0] * num_splits
    else:
        end_shifts = list(range(1, num_shifts + 1)) + [num_shifts] * (num_splits - num_shifts)
        begin_shifts = [0] + end_shifts[:-1]
    splits = [
        seq[i * chunk_size + b : (i + 1) * chunk_size + e] for i, b,
        e in zip(range(num_splits), begin_shifts, end_shifts)]
    return splits


def compute_num_frames(duration: Seconds, frame_shift: Seconds, sampling_rate: int) -> int:
    """
    Compute the number of frames from duration and frame_shift in a safe way,
    matching the reference rounding exactly (utils.py:410-421): num_samples and
    window_hop are rounded first, then ``(num_samples + hop//2) // hop``.
    """
    num_samples = round(duration * sampling_rate)
    window_hop = round(frame_shift * sampling_rate)
    num_frames = int((num_samples + window_hop // 2) // window_hop)
    return num_frames


def compute_num_frames_from_samples(
    num_samples: int, frame_shift: Seconds, sampling_rate: int) -> int:
    """Reference: utils.py:424-434."""
    window_hop = round(frame_shift * sampling_rate)
    num_frames = int((num_samples + window_hop // 2) // window_hop)
    return num_frames


@lru_cache(maxsize=16384)
def compute_num_samples(
    duration: Seconds, sampling_rate: Union[int, float], rounding=ROUND_HALF_UP) -> int:
    """
    Convert a time quantity to the number of samples given a specific sampling rate.
    Performs consistent rounding up or down (not banker's rounding), matching
    reference utils.py:657-668 exactly (round to 8 decimal digits first, then
    Decimal-quantize with the requested rounding mode).

    Memoized: the Decimal round trip costs ~3 us and the hot data path calls
    this tens of thousands of times per epoch over a bounded set of
    (duration, rate) pairs.
    """
    return int(Decimal(round(duration * sampling_rate, ndigits=8)).quantize( 0, rounding=rounding ))


@lru_cache(maxsize=16384)
def perturb_num_samples(num_samples: int, factor: float) -> int:
    """Mimics the behavior of speed perturbation on the number of samples
    (reference: utils.py:649-654). Memoized (see compute_num_samples)."""
    rounding = ROUND_HALF_UP if factor >= 1.0 else ROUND_HALF_DOWN
    return int(Decimal(round(num_samples / factor, ndigits=8)).quantize(0, rounding=rounding))


def add_durations(*durs: Seconds, sampling_rate: int) -> Seconds:
    """
    Adds durations in a way that avoids floating point precision issues
    (reference: utils.py:672-681): convert to sample counts, add, convert back.
    """
    tot_num_samples = sum(compute_num_samples(d, sampling_rate=sampling_rate) for d in durs)
    return tot_num_samples / sampling_rate


@dataclass(unsafe_hash=True)
class TimeSpan:
    """A simple beginning/end time span (reference: utils.py:300)."""

    start: Seconds
    end: Seconds

    @property
    def duration(self) -> Seconds:
        return self.end - self.start


def overlaps(lhs: Any, rhs: Any) -> bool:
    """Indicates whether two time-spans/segments are overlapping or not
    (reference: utils.py:309)."""
    return (
        lhs.start < rhs.end
        and rhs.start < lhs.end
        and not isclose(lhs.start, rhs.end)
        and not isclose(rhs.start, lhs.end)
    )


def overspans(spanning: Any, spanned: Any, tolerance: float = 1e-3) -> bool:
    """Indicates whether the left-hand-side time-span covers the whole
    right-hand-side time-span, up to ``tolerance`` seconds of slack on either
    edge (reference: utils.py:216)."""
    return (
        spanning.start - tolerance
        <= spanned.start
        <= spanned.end
        <= spanning.end + tolerance
    )


def measure_overlap(lhs: Any, rhs: Any) -> float:
    """Given two objects with start/end attributes, return the % of their
    overlapped time relative to the shorter of the two (reference: utils.py:809)."""
    lhs, rhs = sorted([lhs, rhs], key=lambda item: item.start)
    overlapped_area = lhs.end - rhs.start
    if overlapped_area <= 0:
        return 0.0
    dur = min(lhs.end - lhs.start, rhs.end - rhs.start)
    return overlapped_area / dur


def is_none_or_gt(value, threshold) -> bool:
    """True when value is None or greater than threshold."""
    return value is None or value > threshold


def save_rng_state(rng: Optional[random.Random]) -> dict:
    """JSON-serializable snapshot of a ``random.Random`` state."""
    if rng is None:
        rng = random.Random()
    version, internal, gauss_next = rng.getstate()
    return {"version": version, "state": list(internal), "gauss_next": gauss_next}


def load_rng_state(state: dict, rng: Optional[random.Random] = None) -> random.Random:
    """Restore a ``random.Random`` from :func:`save_rng_state` output
    (into ``rng`` if given, else a fresh instance)."""
    if rng is None:
        rng = random.Random()
    rng.setstate((state["version"], tuple(state["state"]), state["gauss_next"]))
    return rng


@lru_cache(maxsize=None)
def _module_available(m: str) -> bool:
    import importlib.util

    try:
        return importlib.util.find_spec(m) is not None
    except (ImportError, ValueError):
        # find_spec raises for dotted names whose parent package is
        # missing (e.g. "s3prl.hub" without s3prl installed).
        return False


def is_module_available(*modules: str) -> bool:
    """Check whether the given modules can be imported, without importing
    them. Cached: a negative find_spec walks the whole sys.path on every
    call (failed imports are never cached by Python), which is measurable
    in per-recording hot loops like backend applicability checks."""
    return all(_module_available(m) for m in modules)


def is_valid_url(value: str) -> bool:
    from urllib.parse import urlparse

    try:
        result = urlparse(value)
        return bool(result.scheme) and bool(result.netloc)
    except AttributeError:
        return False


@contextmanager
def suppress_and_warn(*exceptions, enabled: bool = True):
    """Context manager that suppresses the given exception types and emits a warning."""
    import warnings

    if not enabled:
        yield
        return
    try:
        yield
    except exceptions as e:
        warnings.warn(f"Suppressed exception: {type(e).__name__}: {e}")


def rich_exception_info(fn: Callable) -> Callable:
    """
    Decorator that appends the function arguments repr to raised exceptions
    (reference: utils.py:855) to help debug which manifest caused an error.
    """
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            raise type(e)(
                f"{e}\n[extra info] When calling: {fn.__name__}(args={args} kwargs={kwargs})"
            ) from e

    return wrapper


def to_list(item: Union[Any, List[Any]]) -> List[Any]:
    """Convert ``item`` to a list if it is not already a list."""
    return item if isinstance(item, list) else [item]


def merge_items_with_delimiter(
    values: Iterable[str], prefix: str = "cat", delimiter: str = "#", return_first: bool = False,
) -> Optional[str]:
    """Merge a sequence of strings into one with a delimiter
    (reference: utils.py:726), used when merging supervision fields.
    Duplicates are kept (matches the reference's wire output for
    ``merge_supervisions``, e.g. repeated speaker names)."""
    values = list(values)
    if len(values) == 0:
        return None
    if len(values) == 1 or return_first:
        return values[0]
    return delimiter.join([prefix] + values)


def supervision_to_frames(
    supervision, frame_shift: Seconds, sampling_rate: int, max_frames: Optional[int] = None,
) -> Tuple[int, int]:
    """
    Convert a supervision's time span into a (start_frame, num_frames) tuple
    (reference: utils.py:743).
    """
    start_frame = compute_num_frames(
        supervision.start, frame_shift=frame_shift, sampling_rate=sampling_rate)
    num_frames = compute_num_frames(
        supervision.duration, frame_shift=frame_shift, sampling_rate=sampling_rate)
    if max_frames:
        diff = start_frame + num_frames - max_frames
        if diff > 0:
            num_frames -= diff
    return start_frame, num_frames


def supervision_to_samples(
    supervision, sampling_rate: int, max_samples: Optional[int] = None) -> Tuple[int, int]:
    """Convert a supervision's time span into (start_sample, num_samples)
    (reference: utils.py:765)."""
    start_sample = compute_num_samples(supervision.start, sampling_rate)
    num_samples = compute_num_samples(supervision.duration, sampling_rate)
    if max_samples:
        diff = start_sample + num_samples - max_samples
        if diff > 0:
            num_samples -= diff
    return start_sample, num_samples


def is_equal_or_contains(value: Union[Any, List[Any]], other: Union[Any, List[Any]]) -> bool:
    value = to_list(value)
    other = to_list(other)
    return set(other).issubset(set(value))


def hash_str_to_int(s: str, max_value: Optional[int] = None) -> int:
    """Hash a string to a stable integer in ``[0, max_value)``, used for
    deterministic per-item RNG seeds (reference: utils.py:837 — SHA-1 based,
    matched exactly so seeded pipelines reproduce across implementations)."""
    import hashlib
    import sys as _sys

    if max_value is None:
        max_value = _sys.maxsize
    return int(hashlib.sha1(s.encode("utf-8")).hexdigest(), 16) % max_value


def split_manifest_lazy(
    it: Iterable[Any], output_dir: Pathlike, chunk_size: int, prefix: str = "", num_digits: int = 8,
    start_idx: int = 0) -> List:
    """
    Split a manifest into chunks of ``chunk_size`` items, saving each chunk to
    ``{output_dir}/{prefix}.{split_idx}.jsonl.gz`` as the input is consumed.
    Returns the list of lazily re-opened chunks.
    """
    from lhotse_tpu_torch.serialization import SequentialJsonlWriter, load_manifest_lazy

    in_progress = True
    items = iter(it)
    split_idx = start_idx
    splits = []
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    while in_progress:
        try:
            item = next(items)
        except StopIteration:
            break
        idx = f"{split_idx:0{num_digits}d}"
        if prefix:
            path = output_dir / f"{prefix}.{idx}.jsonl.gz"
        else:
            path = output_dir / f"{idx}.jsonl.gz"
        with SequentialJsonlWriter(path) as writer:
            writer.write(item)
            for _ in range(chunk_size - 1):
                try:
                    writer.write(next(items))
                except StopIteration:
                    in_progress = False
                    break
        splits.append(load_manifest_lazy(path))
        split_idx += 1
    return splits


def not_ported(what: str) -> NotImplementedError:
    """The error a copied body raises where the original reaches a part of
    ``lhotse_tpu`` that this package does not have yet."""
    return NotImplementedError(f"{what} is not ported to lhotse_tpu_torch yet.")
