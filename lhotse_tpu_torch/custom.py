"""
CustomFieldMixin: attribute-style access to user-defined ``custom`` fields
(copied from ``lhotse_tpu/custom.py``). Loading a custom ``Recording``,
``Array`` or ``TemporalArray`` is ported; custom images are not and raise.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional

import numpy as np

from lhotse_tpu_torch.utils import asdict_nonull, fastcopy, ifnone


class CustomFieldMixin:
    """
    Mixin for classes (Cut, SupervisionSegment) that hold custom user-defined
    fields. Note: dataclasses inheriting from this mixin must re-declare the
    ``custom`` attribute (pre-3.10 dataclass semantics).
    """

    def __init__(self, custom: Optional[Dict[str, Any]]) -> None:
        self.custom: Optional[Dict[str, Any]] = custom

    def __setattr__(self, key: str, value: Any) -> None:
        if key in self.__dataclass_fields__:
            return super().__setattr__(key, value)
        # Everything else routes into the custom dict; assigning None removes.
        store = ifnone(self.custom, {})
        if value is not None:
            store[key] = value
        else:
            store.pop(key, None)
        if store:
            self.custom = store

    def __getattr__(self, name: str) -> Any:
        store = self.custom
        if store is not None:
            if name in store:
                return store[name]
            if name.startswith("load_"):
                return partial(self.load_custom, name[len("load_"):])
        raise AttributeError(f"No such attribute: {name}")

    def __delattr__(self, key: str) -> None:
        if key in self.__dataclass_fields__:
            super().__delattr__(key)
        store = self.custom
        if store is None or key not in store:
            raise AttributeError(f"No such member: '{key}'")
        del store[key]

    def to_dict(self) -> Dict[str, Any]:
        return asdict_nonull(self)

    def with_custom(self, name: str, value: Any):
        """Return a copy of this object with an extra custom field assigned."""
        dup = fastcopy(self, custom=dict(ifnone(self.custom, {})))
        dup.custom[name] = value
        return dup

    def copy_with(self, **kwargs):
        """Copy with selected fields overwritten (fastcopy convenience)."""
        return fastcopy(self, **kwargs)

    def _load_custom_recording(self, name: str, value, **kwargs) -> np.ndarray:
        channels = self.custom.get(f"{name}_channel_selector")
        if channels is None and "channel" in kwargs:
            channels = kwargs.pop("channel")
        if self.custom.get(f"{name}_unaligned", False):
            # Opt-out marker: the recording is not time-aligned to this cut.
            return value.load_audio(channels=channels, **kwargs)
        window = dict(offset=self.start, duration=self.duration)
        return value.load_audio(channels=channels, **window, **kwargs)

    def load_custom(self, name: str, **kwargs) -> np.ndarray:
        """
        Load custom data as a numpy array from an Array / TemporalArray /
        Recording manifest stored in ``custom`` — TemporalArray and Recording
        values are sliced to this object's [start, start+duration).
        """
        from lhotse_tpu_torch.array import Array, TemporalArray
        from lhotse_tpu_torch.audio import Recording

        value = self.custom.get(name)
        if isinstance(value, Recording):
            return self._load_custom_recording(name, value, **kwargs)
        if isinstance(value, TemporalArray):
            return value.load(start=self.start, duration=self.duration, **kwargs)
        if isinstance(value, Array):
            return value.load(**kwargs)
        raise ValueError(
            f"To load {name}, the object needs field {name} (or custom['{name}']) "
            f"holding a manifest of type Array, TemporalArray, Recording, or Image."
        )

    def has_custom(self, name: str) -> bool:
        return name in self.custom if self.custom is not None else False

    def drop_custom(self, name: str):
        if not self.has_custom(name):
            return None
        del self.custom[name]
        return self
