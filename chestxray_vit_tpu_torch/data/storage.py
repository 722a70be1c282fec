"""Storage backends of the port, a copy of
``chestxray_vit_tpu/data/storage.py``: the GCS bucket, the same layout on
a local filesystem, and an in-memory fake.

One client is shared with connection reuse (the reference made a client
per sample), and the blob-name map is built once. ``LocalStore`` serves
the bucket layout from disk; ``MemoryStore`` is the in-process fake that
tests and smoke runs fill (``data/testing.py``). ``google.cloud.storage``
is imported only when a ``GCSStore`` is built. ``GCSStore`` also writes
and deletes objects (``put``, ``delete``): the port's ``gs://``
checkpoints go through it (``train/checkpoint.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Protocol

from chestxray_vit_tpu_torch.config import DataConfig


class Store(Protocol):
    def get(self, name: str) -> bytes: ...
    def list(self, prefix: str) -> List[str]: ...
    def exists(self, name: str) -> bool: ...


class MemoryStore:
    """In-memory bucket fake."""

    def __init__(self, blobs: Optional[Dict[str, bytes]] = None):
        self._blobs: Dict[str, bytes] = dict(blobs or {})

    def put(self, name: str, data: bytes) -> None:
        self._blobs[name] = data

    def get(self, name: str) -> bytes:
        return self._blobs[name]

    def list(self, prefix: str) -> List[str]:
        return sorted(n for n in self._blobs if n.startswith(prefix))

    def exists(self, name: str) -> bool:
        return name in self._blobs


class LocalStore:
    """Bucket layout rooted at a directory."""

    def __init__(self, root: str):
        self.root = root

    def _path(self, name: str) -> str:
        return os.path.join(self.root, name)

    def get(self, name: str) -> bytes:
        with open(self._path(name), "rb") as f:
            return f.read()

    def list(self, prefix: str) -> List[str]:
        out: List[str] = []
        base = self._path(prefix)
        parent = base if os.path.isdir(base) else os.path.dirname(base)
        for dirpath, _dirs, files in os.walk(parent):
            for fn in files:
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, self.root)
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))


class GCSStore:
    """google-cloud-storage backend: one client and bucket handle serve
    every thread (the client is documented thread-safe for reads; its HTTP
    session pools connections)."""

    def __init__(self, bucket_name: str, project: Optional[str] = None):
        from google.cloud import storage  # only where a bucket is read

        if project:
            self._client = storage.Client(project=project)
        else:
            # no project configured: prefer Application Default Credentials
            # (project inferred from the environment) — falling straight to
            # an anonymous client would 401/403 every call against private
            # buckets even when the user HAS working credentials, and the
            # pipeline would then silently train on black dummy images
            try:
                self._client = storage.Client()
            except Exception:                            # noqa: BLE001
                # no ADC available: public-bucket access still works
                self._client = storage.Client.create_anonymous_client()
        self._bucket = self._client.bucket(bucket_name)

    def get(self, name: str) -> bytes:
        return self._bucket.blob(name).download_as_bytes()

    def list(self, prefix: str) -> List[str]:
        return [b.name for b in self._client.list_blobs(
            self._bucket, prefix=prefix)]

    def exists(self, name: str) -> bool:
        return self._bucket.blob(name).exists()

    def put(self, name: str, data: bytes) -> None:
        """Upload ``data`` as ``name`` (the checkpoint writer's only write;
        the JAX package writes its checkpoints through orbax)."""
        self._bucket.blob(name).upload_from_string(data)

    def delete(self, name: str) -> None:
        self._bucket.blob(name).delete()


class RetryingStore:
    """Bounded retry with exponential backoff around a network-backed store.

    The loader degrades a failed fetch to a black dummy image; retrying
    first keeps that as the last resort, not the first response. The
    backoff is deterministic (no rng).
    """

    def __init__(self, inner: Store, retries: int = 3,
                 base_delay: float = 0.2):
        self.inner = inner
        self.retries = retries
        self.base_delay = base_delay

    @staticmethod
    def _is_permanent(e: Exception) -> bool:
        """Missing blobs are not transient — KeyError/FileNotFoundError for
        the local/memory backends, google.api_core NotFound (plain Exception
        subclass, HTTP 404) for the GCS backend."""
        if isinstance(e, (KeyError, FileNotFoundError)):
            return True
        try:
            from google.api_core import exceptions as gexc
        except ImportError:
            return False
        return isinstance(e, gexc.NotFound)

    def _retry(self, fn, *args):
        import time as _time
        for attempt in range(self.retries + 1):
            try:
                return fn(*args)
            except Exception as e:                       # noqa: BLE001
                if self._is_permanent(e):
                    raise
                if attempt == self.retries:
                    raise
                delay = self.base_delay * (2 ** attempt)
                print(f"[storage] {fn.__name__} failed ({e}); "
                      f"retry {attempt + 1}/{self.retries} in {delay:.1f}s")
                _time.sleep(delay)

    def get(self, name: str) -> bytes:
        return self._retry(self.inner.get, name)

    def list(self, prefix: str) -> List[str]:
        return self._retry(self.inner.list, prefix)

    def exists(self, name: str) -> bool:
        return self._retry(self.inner.exists, name)


def open_store(cfg: DataConfig, memory_store: Optional[MemoryStore] = None
               ) -> Store:
    if cfg.backend == "memory":
        if memory_store is None:
            raise ValueError("memory backend needs a MemoryStore instance")
        return memory_store
    if cfg.backend == "local":
        return LocalStore(cfg.local_root or ".")
    if cfg.backend == "gcs":
        return RetryingStore(
            GCSStore(cfg.gcs_bucket_name, cfg.gcp_project_id or None))
    raise ValueError(f"unknown storage backend {cfg.backend!r}")


def build_blob_map(store: Store, cfg: DataConfig) -> Dict[str, str]:
    """{basename → full blob name} over images_001..012/images/: skips
    directory placeholders, warns and goes on past a folder that fails to
    list."""
    blob_map: Dict[str, str] = {}
    base = cfg.gcs_image_base_prefix
    for i in range(1, cfg.num_image_folders + 1):
        prefix = base + cfg.image_folder_template.format(i)
        try:
            names: Iterable[str] = store.list(prefix)
        except Exception as e:                        # noqa: BLE001
            print(f"[storage] warning: listing {prefix} failed: {e}")
            continue
        for name in names:
            if name.endswith("/"):
                continue
            blob_map[os.path.basename(name)] = name
    return blob_map
