"""
Host helpers of the data path (copied from ``lhotse_tpu/utils/core.py``):
time/sample/frame arithmetic, windowing and context extension, dataclass
helpers, seeding, the streaming buffer shuffle, the recipes' directory
globbing, recursion limit, safe tar and RAR extraction and resumable
download, ``SmartOpen`` (URLs through the optional ``smart_open``
package), and the small public helpers users import directly
(``build_rng``, ``deprecated``, ``lens_to_mask``, ``pairwise``, ...).
Each body is the original's.
"""
from __future__ import annotations

import math
import os
import random
import secrets
import sys
import uuid
import warnings
from contextlib import contextmanager
from dataclasses import dataclass, fields
from decimal import ROUND_HALF_DOWN, ROUND_HALF_UP, Decimal
from functools import lru_cache, wraps
from math import ceil, isclose
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple, TypeVar, Union

import numpy as np

Pathlike = Union[Path, str]
T = TypeVar("T")

Seconds = float
Decibels = float
Channels = Union[int, List[int]]

INT16MAX = 32768
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


def compute_num_windows(sig_len: Seconds, win_len: Seconds, hop: Seconds) -> int:
    """
    Return the number of windows obtained from a signal of length ``sig_len``
    with windows of ``win_len`` and shift ``hop`` (reference: utils.py:437-466).
    """
    n = ceil(max(sig_len - win_len, 0) / hop)
    b = (sig_len - n * hop) > 0
    return (sig_len > 0) * (n + int(b))


def compute_start_duration_for_extended_cut(
    start: Seconds, duration: Seconds, new_duration: Seconds, direction: str = "center",
) -> Tuple[Seconds, Seconds]:
    """
    Compute new "start" for an interval extended to ``new_duration`` towards
    ``direction`` in ("center", "left", "right", "random");
    reference: utils.py:684-723.
    """
    if new_duration <= duration:
        return start, duration
    if direction == "center":
        new_start = start - (new_duration - duration) / 2
    elif direction == "left":
        new_start = start - (new_duration - duration)
    elif direction == "right":
        new_start = start
    elif direction == "random":
        new_start = random.uniform(start - (new_duration - duration), start)
    else:
        raise ValueError(f"Unexpected direction: {direction}")
    if new_start < 0:
        new_duration = round(new_duration + new_start, ndigits=15)
        new_start = 0
    return round(new_start, ndigits=15), new_duration


def duration_to_num_samples_check(duration: Seconds, num_samples: int, sampling_rate: int) -> bool:
    return compute_num_samples(duration, sampling_rate) == num_samples


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


def index_by_id_and_check(manifests: Iterable[T]) -> Dict[str, T]:
    id2man = {}
    for m in manifests:
        assert m.id not in id2man, f"Duplicated manifest ID: {m.id}"
        id2man[m.id] = m
    return id2man


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


def measure_overlap_frac(lhs: Any, rhs: Any) -> float:
    """Fraction of ``lhs`` covered by overlap with ``rhs``."""
    if not overlaps(lhs, rhs):
        return 0.0
    dur = min(lhs.end, rhs.end) - max(lhs.start, rhs.start)
    return dur / (lhs.end - lhs.start) if lhs.end > lhs.start else 0.0


class SmartOpen:
    """Deferred import wrapper around ``smart_open`` (optional dependency)."""

    transport_params: Optional[dict] = None

    @classmethod
    def setup(cls, transport_params: Optional[dict] = None):
        """Configure default transport params for subsequent opens (warns
        when overwriting a prior setup)."""
        if not is_module_available("smart_open"):
            raise ImportError(
                "The 'smart_open' package is required to open URLs; "
                "pip install smart_open (not bundled in this environment)."
            )
        if cls.transport_params is not None and cls.transport_params != transport_params:
            import logging

            logging.warning(
                "SmartOpen.setup second call overwrites existing transport_params "
                f"with new version\t\n{cls.transport_params}\t\nvs\t\n{transport_params}"
            )
        cls.transport_params = transport_params

    @classmethod
    def open(cls, uri, mode="rb", transport_params: Optional[dict] = None, **kwargs):
        if not is_module_available("smart_open"):
            raise ImportError(
                "The 'smart_open' package is required to open URLs; "
                "pip install smart_open (not bundled in this environment)."
            )
        import smart_open

        if transport_params is None:
            transport_params = cls.transport_params
        if transport_params is not None:
            kwargs["transport_params"] = transport_params
        return smart_open.open(uri, mode, **kwargs)


def is_valid_url(value: str) -> bool:
    from urllib.parse import urlparse

    try:
        result = urlparse(value)
        return bool(result.scheme) and bool(result.netloc)
    except AttributeError:
        return False


class Pipe:
    """
    A wrapper class for subprocess.Pipe used by the ``pipe:`` I/O backend
    (copied from ``lhotse_tpu/utils/core.py``). Starts a subprocess for the given command and
    exposes a file-like API over its stdout (read) or stdin (write), raising
    on nonzero exit status from the wrapped command.

    Unlike the JAX package's, a text mode (no ``b``) reads and writes UTF-8
    text and the pipe iterates over its lines, so JSONL manifests stream
    through ``pipe:`` identifiers (the JAX package's pipe yields bytes and
    is not iterable, so its ``load_jsonl`` and ``to_file`` fail on one).
    """

    def __init__(
        self, cmd: str, mode: str = "rb", shell: bool = True, timeout: Optional[float] = None,
        ignore_status: Optional[List[int]] = None, ignore_errors: bool = False):
        import subprocess

        self.cmd = cmd
        self.mode = mode
        self.timeout = timeout
        self.ignore_status = [0] + (ignore_status or [])
        self.ignore_errors = ignore_errors
        text = {} if "b" in mode else {"encoding": "utf-8"}
        if mode[0] == "r":
            self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, shell=shell, **text)
            self.stream = self.proc.stdout
        elif mode[0] == "w":
            self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, shell=shell, **text)
            self.stream = self.proc.stdin
        else:
            raise ValueError(f"Invalid mode for Pipe: {mode}")
        if self.stream is None:
            raise RuntimeError(f"Subprocess pipe stream is unavailable for: {cmd}")
        self.status: Optional[int] = None

    def check_status(self):
        self.wait_for_child()

    def is_running(self) -> bool:
        """True while the wrapped subprocess has not yet exited."""
        return self.proc.poll() is None

    def wait_for_child(self):
        if self.status is not None:
            return
        self.status = self.proc.wait(timeout=self.timeout)
        if self.status not in self.ignore_status and not self.ignore_errors:
            raise RuntimeError(f"Command '{self.cmd}' exited with status {self.status}")

    def read(self, *args, **kwargs):
        result = self.stream.read(*args, **kwargs)
        if not result:
            self.wait_for_child()
        return result

    def readline(self, *args, **kwargs):
        result = self.stream.readline(*args, **kwargs)
        if not result:
            self.wait_for_child()
        return result

    def __iter__(self):
        yield from self.stream
        self.wait_for_child()

    def write(self, *args, **kwargs):
        return self.stream.write(*args, **kwargs)

    def flush(self):
        return self.stream.flush()

    def close(self):
        try:
            self.stream.close()
        finally:
            self.wait_for_child()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getattr__(self, item):
        return getattr(self.stream, item)


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


def during_docs_build() -> bool:
    return bool(os.environ.get("READTHEDOCS"))


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


def to_hashable(item: Any) -> Any:
    """Convert a list to a tuple for hashability; pass through other types."""
    return tuple(item) if isinstance(item, list) else item


def streaming_shuffle(data: Iterable[T], bufsize: int = 10000, rng: Optional[random.Random] = None):
    """
    Shuffle the data in the stream using a fixed-size buffer (webdataset-style;
    the algorithm of :class:`lhotse_tpu_torch.lazy.LazyShuffler`):
    during warm-up, items are pulled two at a time into the buffer; afterwards each
    arriving item trades places with a random resident before being emitted, and the
    tail of the buffer drains in arrival order.
    """
    if rng is None:
        rng = random.Random()
    it = iter(data)
    buf: List[T] = []
    warming_up = True
    for sample in it:
        if len(buf) < bufsize:
            try:
                buf.append(next(it))
            except StopIteration:
                pass
        if buf:
            k = rng.randint(0, len(buf) - 1)
            sample, buf[k] = buf[k], sample
        if warming_up and len(buf) < bufsize:
            buf.append(sample)
            continue
        warming_up = False
        yield sample
    yield from buf


def check_and_rglob(path, pattern: str, strict: bool = True) -> list:
    """Assert ``path`` is a directory, recursively glob ``pattern`` inside,
    and (with strict=True) assert at least one match."""
    path = Path(path)
    assert path.is_dir(), f"No such directory: {path}"
    matches = sorted(path.rglob(pattern))
    if strict:
        assert len(matches) > 0, (f"No files matching pattern '{pattern}' in directory: {path}")
    return matches


@contextmanager
def recursion_limit(stack_size: int):
    """Python's recursion limit set to ``stack_size`` inside the block, and
    the old limit restored on the way out, also on an error."""
    old_size = sys.getrecursionlimit()
    sys.setrecursionlimit(stack_size)
    try:
        yield
    finally:
        sys.setrecursionlimit(old_size)


def safe_extract(tar, path: Pathlike = ".", members=None, *, numeric_owner=False):
    """tar extraction guarding against path traversal (reference: utils.py:585)."""

    def _is_within_directory(directory, target):
        abs_directory = os.path.abspath(directory)
        abs_target = os.path.abspath(target)
        prefix = os.path.commonprefix([abs_directory, abs_target])
        return prefix == abs_directory

    for member in tar.getmembers():
        member_path = os.path.join(path, member.name)
        if not _is_within_directory(path, member_path):
            raise Exception("Attempted Path Traversal in Tar File")
    tar.extractall(path, members, numeric_owner=numeric_owner)


def safe_extract_rar(rar, path: Pathlike = ".", members=None):
    """rar extraction guarding against path traversal."""
    for member in rar.namelist():
        member_path = os.path.join(path, member)
        abs_directory = os.path.abspath(path)
        abs_target = os.path.abspath(member_path)
        if os.path.commonprefix([abs_directory, abs_target]) != abs_directory:
            raise Exception("Attempted Path Traversal in RAR File")
    rar.extractall(path, members)


def resumable_download(
    url: str, filename: Pathlike, force_download: bool = False,
    completed_file_size: Optional[int] = None, missing_ok: bool = False,
    ssl_context=None, additional_headers: Optional[Dict[str, str]] = None,
    request_ssl_context=None) -> None:
    """
    Download a file with support for resuming partial downloads via HTTP Range
    requests (reference: utils.py:471). Uses urllib; no external dependencies.
    ``request_ssl_context`` is a deprecated alias of ``ssl_context``.
    """
    import urllib.request

    if ssl_context is None:
        ssl_context = request_ssl_context
    filename = Path(filename)
    if filename.exists():
        if completed_file_size is not None and filename.stat().st_size == completed_file_size:
            return
        if not force_download and completed_file_size is None:
            return
    filename.parent.mkdir(parents=True, exist_ok=True)
    partial = filename.stat().st_size if filename.exists() and not force_download else 0
    req = urllib.request.Request(url)
    for hname, hval in (additional_headers or {}).items():
        req.add_header(hname, hval)
    if partial:
        req.add_header("Range", f"bytes={partial}-")
    mode = "ab" if partial else "wb"
    try:
        with urllib.request.urlopen(req, context=ssl_context) as resp, \
                open(filename, mode) as f:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                f.write(chunk)
    except Exception:
        if missing_ok:
            return
        raise


class nullcontext:
    def __init__(self, enter_result=None, *args, **kwargs):
        self.enter_result = enter_result

    def __enter__(self):
        return self.enter_result

    def __exit__(self, *excinfo):
        pass


def build_rng(seed) -> random.Random:
    """``random.Random(seed)``, or a true-entropy SystemRandom for "trng"."""
    if seed == "trng":
        return secrets.SystemRandom()
    return random.Random(seed)


class DeprecatedWarning(UserWarning):
    """Category used for deprecation warnings: a ``UserWarning`` subclass so
    it is shown by default, unlike :class:`DeprecationWarning`."""


def deprecated(message: str):
    """Decorator marking a function as deprecated; emits a warning per call."""

    def decorator(func):
        @wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(message, DeprecatedWarning, stacklevel=2)
            return func(*args, **kwargs)

        wrapper.__doc__ = f"[DEPRECATED] {message}\n\n{func.__doc__ or ''}"
        return wrapper

    return decorator


def lens_to_mask(lens) -> np.ndarray:
    """(B,) integer lengths -> (B, max_len) float32 0/1 mask (accepts any
    integer array-like)."""
    lens = np.asarray(lens)
    mask = np.zeros((lens.shape[0], int(lens.max())), dtype=np.float32)
    for i, num in enumerate(lens):
        mask[i, : int(num)] = 1.0
    return mask


def pairwise(iterable):
    """s -> (s0, s1), (s1, s2), ..."""
    from itertools import tee

    a, b = tee(iterable)
    next(b, None)
    return zip(a, b)


def time_diff_to_num_frames(time_diff: Seconds, frame_length: Seconds, frame_shift: Seconds) -> int:
    """Number of whole frames fitting inside ``time_diff``."""
    if isclose(time_diff, 0.0):
        return 0
    return int(ceil((time_diff - frame_length) / frame_shift))


def is_torchaudio_available() -> bool:
    return is_module_available("torchaudio")


def is_torchcodec_available() -> bool:
    return is_module_available("torchcodec")


def replace_bucket_with_profile_name(identifier: str, profile_name: str) -> str:
    """Swap the netloc (bucket) of a storage URL for an MSC profile name."""
    from urllib.parse import urlparse, urlunparse

    return urlunparse(urlparse(identifier)._replace(netloc=profile_name))


def not_ported(what: str) -> NotImplementedError:
    """The error a copied body raises where the original reaches a part of
    ``lhotse_tpu`` that this package does not have yet."""
    return NotImplementedError(f"{what} is not ported to lhotse_tpu_torch yet.")
