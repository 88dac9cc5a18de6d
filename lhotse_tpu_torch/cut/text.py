"""
Text examples for LM and multimodal sampling (copied from
``lhotse_tpu/cut/text.py``): ``LazyTxtIterator`` yields them and
``TokenConstraint`` measures them by their token count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class TextExample:
    """Represents a single text example: a string with optional token ids."""

    text: str
    tokens: Optional[np.ndarray] = None

    @property
    def num_tokens(self) -> Optional[int]:
        if self.tokens is not None:
            return len(self.tokens)
        return None


@dataclass
class TextPairExample:
    """Represents a pair of text examples (e.g. machine translation)."""

    source: TextExample
    target: TextExample

    @property
    def num_tokens(self) -> Optional[int]:
        return self.source.num_tokens
