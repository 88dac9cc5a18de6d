"""Batch loading of remotely stored cut payloads (port of ``lhotse_tpu/ais``):
:class:`AISBatchLoader` with a local or AIStore fetcher, and
:class:`AISRangeReader`."""
from lhotse_tpu_torch.ais.batch_loader import (
    AISBatchLoader, AISBatchLoaderError, BatchFetcher, FetchRequest, LocalBatchFetcher,
    collect_batch_requests)
from lhotse_tpu_torch.ais.range_reader import AISRangeReader

__all__ = [
    "AISBatchLoader", "AISBatchLoaderError", "AISRangeReader", "BatchFetcher", "FetchRequest",
    "LocalBatchFetcher", "collect_batch_requests"]
