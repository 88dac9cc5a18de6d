"""
Seekable file-like view over an AIStore object via HTTP byte-range reads
(copied from ``lhotse_tpu/ais/range_reader.py``; upstream lhotse's
``lhotse/ais/range_reader.py``). Lets the indexed-tar / indexed-jsonl
readers random-access ``ais://`` archives exactly like local files:
``seek()+read(n)`` becomes one ranged GET (O(1) on the server, and the
binary ``.idx`` sidecars already say which ranges to ask for). One
instance per worker — ``_pos`` is not synchronized. Needs the ``aistore``
package.
"""
from __future__ import annotations

from typing import Optional

from lhotse_tpu_torch.utils import is_module_available


class AISRangeReader:
    def __init__(self, url: str):
        assert is_module_available("aistore"), ("AISRangeReader requires the 'aistore' package.")
        self._url = url
        self._obj = None
        self._size: Optional[int] = None
        self._pos = 0

    def _ensure_obj(self):
        if self._obj is None:
            import os

            from aistore import Client

            client = Client(os.environ.get("AIS_ENDPOINT"))
            self._obj = client.fetch_object_by_url(self._url)

    @property
    def size(self) -> int:
        if self._size is None:
            self._ensure_obj()
            self._size = int(self._obj.head()["Content-Length"])
        return self._size

    def seekable(self) -> bool:
        return True

    def readable(self) -> bool:
        return True

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            self._pos = offset
        elif whence == 1:
            self._pos += offset
        elif whence == 2:
            self._pos = self.size + offset
        else:
            raise ValueError(f"Invalid whence: {whence}")
        return self._pos

    def tell(self) -> int:
        return self._pos

    def read(self, n: int = -1) -> bytes:
        self._ensure_obj()
        if n is None or n < 0:
            rng = f"bytes={self._pos}-"
        elif n == 0:
            return b""
        else:
            rng = f"bytes={self._pos}-{self._pos + n - 1}"
        data = self._obj.get_reader(byte_range=rng).read_all()
        self._pos += len(data)
        return data

    def close(self) -> None:
        self._obj = None

    def __getstate__(self):
        # Forked workers re-resolve the object lazily.
        return {"_url": self._url, "_obj": None, "_size": self._size, "_pos": self._pos}

    def __setstate__(self, state):
        self.__dict__.update(state)
