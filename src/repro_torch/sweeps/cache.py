"""On-disk content-addressed result cache for sweep cells.

Layout: ``<root>/<key[:2]>/<key>.json`` — one JSON sweep row per cell,
sharded by the first key byte so a million-cell fleet cache never puts
a million entries in one directory.  Writes are atomic (temp file +
``os.replace``), so concurrent shard workers on a shared filesystem
can populate the same cache without coordination: the worst case of a
racing double-write is the same bytes winning twice.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Dict, Iterator, Optional

__all__ = ["ResultCache"]


def _jsonable(obj):
    """Fallback encoder for row values: numpy scalars (which can leak
    out of report statistics) serialize as their Python equivalents;
    anything else is a real error."""
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    raise TypeError(
        f"sweep row value of type {type(obj).__name__!r} is not JSON-able"
    )


class ResultCache:
    """Content-addressed store of sweep rows, keyed by
    :func:`~repro_torch.sweeps.cellkey.cell_key` digests."""

    def __init__(self, root) -> None:
        self.root = Path(root)
        self.hits = 0
        self.misses = 0
        self.puts = 0

    def path_for(self, key: str) -> Path:
        self._check_key(key)
        return self.root / key[:2] / f"{key}.json"

    def relative_path(self, key: str) -> str:
        """Cache-relative path recorded in campaign manifests."""
        return f"{key[:2]}/{key}.json"

    @staticmethod
    def _check_key(key: str) -> None:
        if len(key) < 8 or any(c not in "0123456789abcdef" for c in key):
            raise ValueError(f"not a cell key: {key!r}")

    def __contains__(self, key: str) -> bool:
        return self.path_for(key).exists()

    def get(self, key: str) -> Optional[Dict[str, object]]:
        """The cached row, or ``None``.  An unreadable/corrupt entry
        counts as a miss (the cell simply re-executes and the entry is
        rewritten) rather than poisoning the campaign."""
        path = self.path_for(key)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                row = json.load(fh)
        except (OSError, ValueError):
            self.misses += 1
            return None
        self.hits += 1
        return row

    def put(self, key: str, row: Dict[str, object]) -> Path:
        path = self.path_for(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = json.dumps(row, default=_jsonable)
        fd, tmp = tempfile.mkstemp(
            dir=str(path.parent), prefix=f".{key[:8]}-", suffix=".tmp"
        )
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.puts += 1
        return path

    def keys(self) -> Iterator[str]:
        if not self.root.is_dir():
            return
        for shard in sorted(self.root.iterdir()):
            if shard.is_dir() and len(shard.name) == 2:
                for f in sorted(shard.glob("*.json")):
                    yield f.stem

    def __len__(self) -> int:
        return sum(1 for _ in self.keys())

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses, "puts": self.puts}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"ResultCache({str(self.root)!r}, {self.stats})"
