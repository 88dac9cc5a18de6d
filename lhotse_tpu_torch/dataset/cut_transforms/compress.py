"""
Compress: per-cut random lossy-codec round trip (copied from
``lhotse_tpu/dataset/cut_transforms/compress.py``). Its draws, renamed ids
and ``state_dict`` are the JAX package's, draw for draw.
"""
import random
from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

from lhotse_tpu_torch.augmentation.compress import Codec
from lhotse_tpu_torch.cut import CutSet
from lhotse_tpu_torch.dataset.dataloading import resolve_seed
from lhotse_tpu_torch.utils import load_rng_state, save_rng_state


@dataclass
class Compress:
    """
    With probability ``p``, round-trips each cut through a lossy codec
    ("opus", "mp3", "vorbis", "gsm") chosen by (optionally weighted) random
    draw; the compression level can be fixed or uniformly sampled.
    """

    codecs: List[Codec]
    compression_level: Union[float, Tuple[float, float]] = 0.9
    codec_weights: Optional[List[float]] = None
    compress_custom_fields: bool = False
    p: float = 0.5
    seed: Union[int, str] = 42
    rng: Optional[random.Random] = None
    preserve_id: bool = False

    def __post_init__(self) -> None:
        assert sorted(self.codecs) == sorted(list(set(self.codecs))), "duplicate codecs"

        if isinstance(self.compression_level, (tuple, list)):
            assert len(self.compression_level) == 2, (
                f"Expected compression_level to be a tuple or a list with two "
                f"values, got {self.compression_level}"
            )
            min_compression, max_compression = self.compression_level
            assert min_compression < max_compression, (
                f"Expected min_compression < max_compression, got "
                f"{min_compression} >= {max_compression}"
            )

        assert 0 <= self.p <= 1, f"Probability p must be between 0 and 1, got {self.p}"

        if self.codec_weights:
            assert len(self.codec_weights) == len(self.codecs), (
                f"Expected codec_weights to be a list with the same length as "
                f"codecs, got len({self.codec_weights}) != len({self.codecs})"
            )
            assert all(w >= 0 for w in self.codec_weights), (
                "All codec weights must be non-negative"
            )
        else:
            self.codec_weights = [1.0 for _ in self.codecs]

        if self.rng is not None and self.seed is not None:
            raise ValueError("Either rng or seed must be provided, not both")
        if self.rng is None:
            self.rng = random.Random(resolve_seed(self.seed))

    def __call__(self, cuts: CutSet) -> CutSet:
        compressed_cuts = []
        for cut in cuts:
            if self.rng.random() <= self.p:
                if isinstance(self.compression_level, (tuple, list)):
                    min_compression, max_compression = self.compression_level
                    compression_level = (
                        self.rng.random() * (max_compression - min_compression)
                        + min_compression
                    )
                else:
                    compression_level = self.compression_level

                codec, *_ = self.rng.choices(self.codecs, weights=self.codec_weights)
                new_cut = cut.compress(
                    codec=codec, compression_level=compression_level,
                    compress_custom_fields=self.compress_custom_fields)
                if not self.preserve_id:
                    new_cut.id = f"{new_cut.id}_{codec}_{compression_level:.2f}"
                compressed_cuts.append(new_cut)
            else:
                compressed_cuts.append(cut)

        return CutSet.from_cuts(compressed_cuts)

    def state_dict(self) -> dict:
        return {"rng_state": save_rng_state(self.rng)}

    def load_state_dict(self, sd: dict) -> None:
        self.rng = load_rng_state(sd["rng_state"], self.rng)
