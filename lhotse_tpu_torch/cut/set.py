"""
CutSet: the eager or lazy collection of cuts (copied from
``lhotse_tpu/cut/set.py``), with the part of its algebra the data path
uses: construction from cuts, manifests and lazy JSONL, ``filter``,
``map``, ``shuffle``, ``repeat``, ``subset``, ``split``, ``modify_ids``,
``sort_by_duration``, ``+`` and checkpointing of the lazy graph.

Left out: mixing, padding, windowing and trimming, feature extraction and
storage, Shar and the other constructors.
"""
from __future__ import annotations

import logging
import warnings
from itertools import islice
from typing import Callable, Dict, Iterable, List, Optional, Sequence, TypeVar, Union

from lhotse_tpu_torch.cut.base import Cut
from lhotse_tpu_torch.cut.mono import MonoCut
from lhotse_tpu_torch.lazy import AlgorithmMixin, LazyMapper
from lhotse_tpu_torch.serialization import Serializable
from lhotse_tpu_torch.supervision import SupervisionSegment
from lhotse_tpu_torch.utils import exactly_one_not_null, ifnone, not_ported, split_sequence

T = TypeVar("T")


def is_cut(example) -> bool:
    # MultiCut, MixedCut and PaddingCut are not ported: MonoCut is every cut here.
    return isinstance(example, MonoCut)


class CutSet(Serializable, AlgorithmMixin):
    """
    A collection of cuts (eager list or lazy iterator graph), with the part
    of the data-prep algebra the data path uses and exact checkpointing.
    """

    def __init__(self, cuts: Optional[Iterable[Cut]] = None) -> None:
        self.cuts = ifnone(cuts, [])

    def __eq__(self, other: "CutSet") -> bool:
        return self.cuts == other.cuts

    data = property(lambda self: self.cuts)
    ids = property(lambda self: (c.id for c in self.cuts))

    @staticmethod
    def from_cuts(cuts: Iterable[Cut]) -> "CutSet":
        return CutSet(list(cuts))

    from_items = from_cuts

    @staticmethod
    def from_dicts(data: Iterable[dict]) -> "CutSet":
        return CutSet.from_cuts(deserialize_cut(cut) for cut in data)

    def to_dicts(self) -> Iterable[dict]:
        return (cut.to_dict() for cut in self)

    def split(
        self, num_splits: int, shuffle: bool = False, drop_last: bool = False) -> List["CutSet"]:
        """Split into ``num_splits`` pieces of (near-)equal size."""
        return [
            CutSet(subset)
            for subset in split_sequence(
                self, num_splits=num_splits, shuffle=shuffle, drop_last=drop_last,
            )
        ]

    def subset(
        self, *, supervision_ids: Optional[Iterable[str]] = None,
        cut_ids: Optional[Iterable[str]] = None, first: Optional[int] = None,
        last: Optional[int] = None) -> "CutSet":
        """Select a subset by first/last N, cut IDs (order-preserving), or
        supervision IDs (drops cuts without matches)."""
        if not exactly_one_not_null(supervision_ids, cut_ids, first, last):
            raise AssertionError("subset() can handle only one non-None arg.")
        if first is not None:
            if first <= 0:
                raise AssertionError("subset(first=...) must be positive")
            return CutSet(list(islice(self, first)))
        if last is not None:
            if last <= 0:
                raise AssertionError("subset(last=...) must be positive")
            total = len(self)
            if last > total:
                return self
            return CutSet(list(islice(self, total - last, total)))
        if supervision_ids is not None:
            wanted = set(supervision_ids)
            kept = [
                cut.filter_supervisions(lambda s: s.id in wanted)
                for cut in self
                if any(s.id in wanted for s in cut.supervisions)
            ]
            return CutSet(kept)
        requested = list(cut_ids)
        id_set = frozenset(requested)
        found = CutSet([cut for cut in self if cut.id in id_set])
        if len(found) < len(requested):
            logging.warning(
                f"In CutSet.subset(cut_ids=...): expected {len(requested)} cuts "
                f"but got {len(found)}."
            )
        return found.sort_like(requested)

    def map(
        self, transform_fn: Callable[[T], T], apply_fn: Optional[Callable[[T], bool]] = is_cut,
    ) -> "CutSet":
        ans = CutSet(LazyMapper(self.data, fn=transform_fn, apply_fn=apply_fn))
        if self.is_lazy:
            return ans
        eager = ans.to_eager()
        # Eager evaluation can validate immediately (reference parity:
        # test_cut_set.py::test_map_cut_set_rejects_noncut).
        assert all(is_cut(c) for c in eager), (
            "CutSet.map: transform_fn must return Cut objects."
        )
        return eager

    def filter_supervisions(self, predicate: Callable[[SupervisionSegment], bool]) -> "CutSet":
        """Keep only supervisions satisfying ``predicate`` (cuts without
        supervisions are preserved)."""
        return self.map(_CutOp("filter_supervisions", predicate))

    def sort_by_duration(self, ascending: bool = False) -> "CutSet":
        """Sort by cut duration (descending by default)."""
        return CutSet(sorted(self, key=(lambda cut: cut.duration), reverse=not ascending))

    def sort_like(self, other: Union["CutSet", Sequence[str]]) -> "CutSet":
        """Reorder to match the cut ID order of ``other``."""
        other_ids = list(other.ids if isinstance(other, CutSet) else other)
        assert set(self.ids) == set(
            other_ids
        ), "sort_like() expects both CutSets to have identical cut IDs."
        index_map: Dict[str, int] = {v: index for index, v in enumerate(other_ids)}
        ans: List[Cut] = [None] * len(other_ids)
        for cut in self:
            ans[index_map[cut.id]] = cut
        return CutSet(ans)

    def modify_ids(self, transform_fn: Callable[[str], str]) -> "CutSet":
        """Transform every cut's ID with ``transform_fn``."""
        return self.map(_RenameCut(transform_fn))

    @property
    def is_indexed(self) -> bool:
        return getattr(self.data, "is_indexed", False)

    @property
    def has_constant_time_access(self) -> bool:
        return getattr(self.data, "has_constant_time_access", False)

    def state_dict(self) -> dict:
        """Collect the checkpoint state of the underlying lazy iterator graph."""
        if not self.is_lazy:
            raise RuntimeError("state_dict() is only supported for lazy CutSets.")
        from lhotse_tpu_torch.checkpoint import collect_state_dict

        return collect_state_dict(self.data)

    def load_state_dict(self, state: dict) -> None:
        """Restore the checkpoint state into the underlying lazy iterator graph."""
        if not self.is_lazy:
            raise RuntimeError("load_state_dict() is only supported for lazy CutSets.")
        from lhotse_tpu_torch.checkpoint import restore_state_dict

        restore_state_dict(self.data, state)

    def __repr__(self) -> str:
        try:
            len_val = len(self)
        except Exception:
            len_val = "<unknown>"
        return f"CutSet(len={len_val}) [underlying data type: {type(self.data)}]"

    def __contains__(self, other: Union[str, Cut]) -> bool:
        if isinstance(other, str):
            return any(other == item.id for item in self)
        return any(other.id == item.id for item in self)

    def __getitem__(self, index_or_id: Union[int, str]) -> Cut:
        try:
            return self.cuts[index_or_id]
        except TypeError:
            # Lazy backend: strings match by id, ints by iteration position.
            if isinstance(index_or_id, str):
                try:
                    return next(item for item in self if item.id == index_or_id)
                except StopIteration:
                    raise KeyError(index_or_id) from None
            try:
                return next(
                    item for idx, item in enumerate(self) if idx == index_or_id
                )
            except StopIteration:
                raise IndexError(index_or_id) from None

    def __len__(self) -> int:
        return len(self.cuts)

    def __iter__(self) -> Iterable[Cut]:
        yield from self.cuts


def deserialize_cut(raw_cut: dict) -> Cut:
    """Dispatch on the 'type' field (reference: cut/set.py:3705)."""
    cut_type = raw_cut.pop("type")
    if cut_type == "MonoCut":
        return MonoCut.from_dict(raw_cut)
    if cut_type in ("MultiCut", "PaddingCut", "MixedCut"):
        raise not_ported(cut_type)
    if cut_type == "Cut":
        warnings.warn("Your manifest uses the legacy cut type name 'Cut'; interpreting as MonoCut.")
        return MonoCut.from_dict(raw_cut)
    raise ValueError(f"Unexpected cut type during deserialization: '{cut_type}'")


class _CutOp:
    """Picklable ``cut -> cut.<method>(*args, **kwargs)``."""

    def __init__(self, method: str, *args, **kwargs):
        self.method = method
        self.args = args
        self.kwargs = kwargs

    def __call__(self, cut):
        return getattr(cut, self.method)(*self.args, **self.kwargs)


class _RenameCut:
    """Picklable ``cut -> cut.with_id(fn(cut.id))``."""

    def __init__(self, transform_fn):
        self.transform_fn = transform_fn

    def __call__(self, cut):
        return cut.with_id(self.transform_fn(cut.id))
