"""
StatelessSampler: infinite random sampling over indexed JSONL manifests
(copied from ``lhotse_tpu/dataset/sampling/stateless.py``). It needs no
state to resume: a ``base_seed`` derived from the global step gives fresh
draws. Each draw picks a manifest weighted by its (scaled) line count, then
a uniform line within it, read through a byte-offset index.
"""
import logging
import random
from functools import reduce
from pathlib import Path
from typing import (Callable, Dict, Generator, Iterable, List, Optional, Sequence, Tuple, Union)

from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.cut.set import deserialize_cut
from lhotse_tpu_torch.dataset.dataloading import get_rank, get_world_size, get_worker_info
from lhotse_tpu_torch.dataset.sampling.base import SamplingDiagnostics
from lhotse_tpu_torch.lazy import Dillable
from lhotse_tpu_torch.serialization import decode_json_line
from lhotse_tpu_torch.utils import Pathlike, Seconds

PathlikeAndScale = Tuple[Pathlike, float]


class StatelessSampler(Dillable):
    """
    Infinite, stateless cut sampler over one or more uncompressed ``.jsonl``
    cut manifests. It has no epochs and never finishes; training resumption
    needs no sampler state — pass a step-dependent ``base_seed`` instead.

    Recommended usage is inside a dataloading worker via
    :class:`~lhotse_tpu_torch.dataset.iterable_dataset.IterableDatasetWrapper`, so
    each worker replica derives a distinct seed from (rank, worker_id).

    Non-bucketing::

        >>> sampler = StatelessSampler(
        ...     cuts_paths=["data/cuts_a.jsonl", "data/cuts_b.jsonl"],
        ...     index_path="data/files.idx",
        ...     base_seed=0,
        ...     max_duration=600.0,
        ... )

    Bucketing with per-cutset scales::

        >>> sampler = StatelessSampler(
        ...     cuts_paths=[("data/cuts_a.jsonl", 2.0), ("data/cuts_b.jsonl", 1.0)],
        ...     index_path="data/files.idx",
        ...     base_seed=0, max_duration=600.0, num_buckets=50,
        ...     quadratic_duration=30.0,
        ... )

    Works only with uncompressed jsonl manifests (byte-offset indexed);
    not with tar/shar archives.
    """

    def __init__(
        self, cuts_paths: Union[Pathlike, Iterable[Pathlike], Iterable[PathlikeAndScale]],
        index_path: Pathlike, base_seed: int, max_duration: Optional[Seconds] = None,
        max_cuts: Optional[int] = None, num_buckets: Optional[int] = None,
        duration_bins: List[Seconds] = None, quadratic_duration: Optional[Seconds] = None) -> None:
        self.paths = []
        self.scales = []
        if isinstance(cuts_paths, (Path, str)):
            self.paths.append(Path(cuts_paths))
            self.scales.append(1.0)
        else:
            cuts_paths = list(cuts_paths)
            if isinstance(cuts_paths[0], (Path, str)):
                for p in cuts_paths:
                    assert isinstance(p, (Path, str)), (
                        "Mixing paths with and without scales is not allowed."
                    )
                    self.paths.append(Path(p))
                    self.scales.append(1.0)
            else:
                for tpl in cuts_paths:
                    assert len(tpl) == 2, (
                        f"Expected (path, scale) but got: {tpl} "
                        f"[note: mixing paths with and without scales is not allowed]"
                    )
                    p, scale = tpl
                    assert isinstance(p, (Path, str)), (f"Path must be a string or Path, got: {p}")
                    assert isinstance(scale, (int, float)), (
                        f"Scale must be an int or float, got: {scale}"
                    )
                    self.paths.append(Path(p))
                    self.scales.append(scale)

        self.index_path = Path(index_path)
        self.max_duration = max_duration
        self.max_cuts = max_cuts
        self.num_buckets = num_buckets
        self.duration_bins = duration_bins
        self.quadratic_duration = quadratic_duration
        self.base_seed = base_seed
        assert any(v is not None for v in (self.max_duration, self.max_cuts)), (
            "At least one of max_duration or max_cuts has to be set."
        )

        self.diagnostics = SamplingDiagnostics()
        self.index = ManifestIndex(self.paths, self.index_path)
        self.scaled_line_counts = [
            lc * scale for lc, scale in zip(self.index.line_counts.values(), self.scales)]
        self._transforms = []
        self.rank = get_rank()
        self.world_size = get_world_size()

    def map(self, fn: Callable[[CutSet], CutSet]) -> "StatelessSampler":
        """Apply ``fn`` to each mini-batch CutSet before yielding it."""
        self._transforms.append(fn)
        return self

    def state_dict(self) -> Dict:
        """Stateless: returns an empty dict."""
        return {}

    def load_state_dict(self, state_dict: Dict) -> None:
        """Stateless: no-op."""
        return

    def __iter__(self) -> Generator[CutSet, None, None]:
        from lhotse_tpu_torch.dataset.sampling.dynamic import DynamicCutSampler
        from lhotse_tpu_torch.dataset.sampling.dynamic_bucketing import (DynamicBucketingSampler,)

        worker_info = get_worker_info()
        worker_id = 0 if worker_info is None else worker_info.id
        my_id = worker_id + 1000 * self.rank
        seed = self.base_seed + my_id
        rng = random.Random(seed)
        logging.info(
            f"[{type(self).__name__}] Initialized sampler RNG with seed {seed} "
            f"(== base_seed={self.base_seed} + my_id={my_id}) "
            f"[ddp_rank={self.rank} worker_id={worker_id}]"
        )

        def _draw_one(n: int):
            # Pick a file weighted by (scaled) line count, then a uniform
            # line; seek straight to its byte range.
            path = rng.choices(self.paths, self.scaled_line_counts)[0]
            spans = self.index.line_offsets[path]
            row = rng.randrange(len(spans) - 1)
            with path.open() as f:
                f.seek(spans[row])
                line = f.read(spans[row + 1] - spans[row])
            cut = deserialize_cut(decode_json_line(line))
            # The same item may repeat within one mini-batch; CutSet
            # requires unique IDs.
            cut.id = f"{cut.id}_it{n}"
            return cut

        def _inner():
            n = 0
            while True:  # infinite cut stream
                yield _draw_one(n)
                n += 1

        common = dict(
            max_duration=self.max_duration, max_cuts=self.max_cuts, shuffle=False, drop_last=False,
            world_size=1, rank=0)
        if self.num_buckets is not None or self.duration_bins is not None:
            inner_sampler = DynamicBucketingSampler(
                _inner(), num_buckets=self.num_buckets, duration_bins=self.duration_bins,
                quadratic_duration=self.quadratic_duration, **common)
        else:
            inner_sampler = DynamicCutSampler(_inner(), **common)
        if self._transforms:
            transforms = list(self._transforms)
            inner_sampler.map(reduce(lambda f, g: (lambda x, f=f, g=g: g(f(x))), transforms))
        self.diagnostics = inner_sampler.diagnostics
        yield from inner_sampler

    def get_report(self) -> str:
        """A string describing the sampling statistics so far."""
        return self.diagnostics.get_report()


class ManifestIndex:
    """
    Line-count + line-byte-offset index over jsonl cut manifests, built on
    the shared binary ``.idx`` sidecar format from :mod:`lhotse_tpu_torch.indexing`
    (uint64-LE begin-bytes + end sentinel). On first use, writes
    ``<manifest>.jsonl.idx`` next to each manifest and a summary file
    (``<line-count> <path>`` per manifest) at ``index_path``; later
    instantiations just load them.
    """

    def __init__(
        self, manifest_paths: Sequence[Pathlike], index_path: Pathlike, force: bool = False,
    ) -> None:
        from lhotse_tpu_torch.indexing import (create_jsonl_index, index_file_path, read_index)

        self.line_counts: Dict[Path, int] = {}
        self.line_offsets: Dict[Path, Tuple[int, ...]] = {}
        for p in map(Path, manifest_paths):
            assert p.suffix == ".jsonl", (
                f"We only support uncompressed .jsonl files in this sampler, "
                f"but received: {p}"
            )

            offset_path = index_file_path(p)
            if force or not offset_path.is_file():
                create_jsonl_index(p, offset_path)
            offsets = tuple(int(o) for o in read_index(offset_path))
            # The last offset is the EOF sentinel, hence len - 1 lines.
            self.line_counts[p] = len(offsets) - 1
            self.line_offsets[p] = offsets

        index_path = Path(index_path)
        if not index_path.is_file() or force:
            with index_path.open("w") as index_f:
                for p, lc in self.line_counts.items():
                    print(f"{lc} {p}", file=index_f)
