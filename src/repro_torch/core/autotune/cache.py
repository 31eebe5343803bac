"""Schema-versioned persistent tuning cache: the port's copy of
``repro.core.autotune.cache`` (pure stdlib), with the same schema kind and
version, so a document written by either package loads in the other.

One JSON document (default ``results/autotune/cache.json``) holding one
entry per tuning key ``(kernel, shape-bucket, dtype, device_kind,
calibration_id)``.  Entries carry the winning config, the predicted
default/best step times, the optional measured refinement, and the top of
the ranked candidate table, so ``show``/``export`` can replay a tuning
decision without re-searching.

Writes are atomic (tmp + rename, the ``campaign.results`` discipline) and
the document round-trips losslessly: ``load`` of a ``save`` reproduces the
entry map exactly.  JSON that is not a cache (no ``kind`` tag) is refused
loudly — pointing ``--cache`` at some other artifact must never silently
overwrite it — as are newer schema versions; older versions keep their
metadata and start with an empty entry map.
"""
from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

SCHEMA_KIND = "autotune_cache"
SCHEMA_VERSION = 1

DEFAULT_CACHE_PATH = Path("results") / "autotune" / "cache.json"

_KEY_SEP = "|"


def entry_key(kernel: str, shape_bucket: str, dtype: str,
              device_kind: str, calibration_id: str) -> str:
    """The canonical cache key.  All five components are part of it: a
    cache tuned against one calibration (or device) never leaks configs
    onto another."""
    parts = (kernel, shape_bucket, dtype, device_kind, calibration_id)
    for p in parts:
        if _KEY_SEP in p:
            raise ValueError(f"cache key component {p!r} contains "
                             f"{_KEY_SEP!r}")
    return _KEY_SEP.join(parts)


def split_key(key: str) -> Tuple[str, str, str, str, str]:
    parts = key.split(_KEY_SEP)
    if len(parts) != 5:
        raise ValueError(f"malformed cache key {key!r}")
    return tuple(parts)  # type: ignore[return-value]


def new_document() -> Dict[str, Any]:
    return {"kind": SCHEMA_KIND, "version": SCHEMA_VERSION,
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"), "entries": {}}


def validate(doc: Dict[str, Any]) -> Dict[str, Any]:
    if not isinstance(doc, dict):
        raise ValueError("autotune cache must be a JSON object")
    if doc.get("kind") != SCHEMA_KIND:
        # refusing kind-less JSON is what keeps `--cache <some-other-
        # artifact>.json` a loud error instead of a silent overwrite
        raise ValueError(f"not an autotune cache (kind={doc.get('kind')!r}, "
                         f"expected {SCHEMA_KIND!r})")
    version = doc.get("version", 0)
    if version > SCHEMA_VERSION:
        raise ValueError(
            f"autotune cache schema v{version} is newer than supported "
            f"v{SCHEMA_VERSION}; upgrade the repo to read this file")
    if version < SCHEMA_VERSION:
        # older minor versions carry no entries this code can trust; the
        # metadata survives and tuning re-fills the map
        doc = {**new_document(), "created": doc.get("created", "")}
    if not isinstance(doc.get("entries"), dict):
        raise ValueError("autotune cache 'entries' must be an object")
    for key, rec in doc["entries"].items():
        split_key(key)
        if "config" not in rec:
            raise ValueError(f"cache entry {key!r} missing 'config'")
    return doc


class TuningCache:
    """Entry store for tuned kernel configs.

    ``path=None`` keeps the cache purely in memory (tests, throwaway
    searches); with a path, every ``put`` persists atomically and a fresh
    ``TuningCache(path)`` sees exactly what was written.
    """

    def __init__(self, path: "os.PathLike | str | None" = DEFAULT_CACHE_PATH):
        self.path = Path(path) if path is not None else None
        if self.path is not None and self.path.exists():
            self.doc = validate(json.loads(self.path.read_text()))
        else:
            self.doc = new_document()

    # ----- core map ----------------------------------------------------------

    @property
    def entries(self) -> Dict[str, Dict[str, Any]]:
        return self.doc["entries"]

    def __len__(self) -> int:
        return len(self.entries)

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        return self.entries.get(key)

    def put(self, key: str, entry: Mapping[str, Any],
            flush: bool = True) -> None:
        split_key(key)   # refuse malformed keys at write time
        self.entries[key] = dict(entry)
        if flush:
            self.flush()

    def items(self, kernel: Optional[str] = None
              ) -> Iterator[Tuple[str, Dict[str, Any]]]:
        for key in sorted(self.entries):
            if kernel is None or split_key(key)[0] == kernel:
                yield key, self.entries[key]

    # ----- persistence -------------------------------------------------------

    def flush(self) -> None:
        """Atomic write; a no-op for in-memory caches."""
        if self.path is None:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self.doc, indent=1, sort_keys=True))
        os.replace(tmp, self.path)

    def export(self, out_path: "os.PathLike | str") -> Path:
        """Write the full document (canonical, sorted) to ``out_path``."""
        out = Path(out_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(validate(self.doc), indent=1,
                                  sort_keys=True))
        return out
