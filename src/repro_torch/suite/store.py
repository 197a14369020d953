"""Content-addressed on-disk store for suite characterization records
(counterpart of ``repro.suite.store``).

Each record is one entry's finished roster row, keyed by the entry's
:meth:`~repro_torch.suite.registry.SuiteEntry.fingerprint` — a hash of
everything that determines the result (workload identity + parameters,
seed, core sweep, schema version, and the device when it is a card).
Re-running a suite therefore re-simulates only the entries whose
fingerprints are missing; everything else is recalled byte-identically
(records store the already-rounded row values, and JSON round-trips them
losslessly).

Layout: ``<root>/<key[:2]>/<key>.json``; writes are atomic (tmp +
``os.replace``) so concurrent runners can share a store.  The root
defaults to ``$REPRO_TORCH_SUITE_STORE`` or ``~/.cache/repro-torch-suite``,
apart from the reference's store, so a port run never recalls a row the
reference computed.

The store is a cache, so a damaged record is never fatal: a record that
is truncated, unreadable, or not a JSON object is skipped (one
``repro_torch.obs`` warning line per record and a ``store.corrupt``
counter bump) and the entry recomputes.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

from repro_torch import obs

__all__ = ["ResultStore", "default_store_root"]


def default_store_root() -> Path:
    env = os.environ.get("REPRO_TORCH_SUITE_STORE")
    if env:
        return Path(env)
    return Path(os.path.expanduser("~")) / ".cache" / "repro-torch-suite"


class ResultStore:
    """Minimal content-addressed JSON record store."""

    def __init__(self, root: str | Path | None = None) -> None:
        self.root = Path(root) if root is not None else default_store_root()

    def _path(self, key: str) -> Path:
        if not key or any(c not in "0123456789abcdef" for c in key):
            raise ValueError(f"store key must be a hex digest, got {key!r}")
        return self.root / key[:2] / f"{key}.json"

    def get(self, key: str) -> dict | None:
        path = self._path(key)
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except FileNotFoundError:
            return None
        except (OSError, ValueError, UnicodeDecodeError) as e:
            # Truncated/corrupt/unreadable record (JSONDecodeError is a
            # ValueError): skip it and recompute.
            self._corrupt(path, type(e).__name__)
            return None
        if not isinstance(rec, dict):
            self._corrupt(path, f"non-object record ({type(rec).__name__})")
            return None
        return rec

    @staticmethod
    def _corrupt(path: Path, why: str) -> None:
        obs.count("store.corrupt")
        obs.warn_once(
            f"store-corrupt:{path}",
            f"skipping corrupt store record {path} ({why}); recomputing")

    def put(self, key: str, record: dict) -> None:
        path = self._path(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(record, f, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def sub(self, name: str) -> "ResultStore":
        """A store rooted at ``<root>/<name>``: keeps record families with
        different schemas (roster rows, simulation cells) apart."""
        return ResultStore(self.root / name)

    def __len__(self) -> int:
        if not self.root.exists():
            return 0
        return sum(1 for _ in self.root.glob("*/*.json"))

    def __contains__(self, key: str) -> bool:
        return self._path(key).exists()

    def keys(self):
        """All record keys currently on disk (sorted for determinism)."""
        if not self.root.exists():
            return
        for path in sorted(self.root.glob("*/*.json")):
            yield path.stem

    def prune(self, keep) -> int:
        """Delete every record for which ``keep(key, record)`` is falsy;
        corrupt records are always deleted.  Returns the number removed
        (``python -m repro_torch.suite --gc``)."""
        removed = 0
        for key in list(self.keys()):
            rec = self.get(key)
            if rec is None or not keep(key, rec):
                try:
                    self._path(key).unlink()
                    removed += 1
                except FileNotFoundError:
                    pass  # concurrent runner got there first
        return removed
