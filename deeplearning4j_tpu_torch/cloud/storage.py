"""Cloud-storage SPI and the remote dataset iterator (port of
``deeplearning4j_tpu/cloud/storage.py``).

Reference: ``aws/s3/uploader/S3Uploader.java`` (multi-part upload,
bucket ensure), ``aws/s3/reader/S3Downloader.java`` (keys/objects/
streams), ``s3/reader/BaseS3DataSetIterator.java`` (iterate DataSets
straight out of a bucket).  URIs select the backend: ``/abs/path`` or
``file://`` -> local, ``gs://`` -> GCS, ``s3://`` -> S3.  The cloud SDKs
are gated as in the JAX package: without the SDK those backends raise
with guidance, and with it they raise ``NotImplementedError``.

:class:`RemoteDataSetIterator` reads the ``.npz`` minibatches of
``scaleout.data`` (the JAX package's files, byte for byte) through a
bounded local cache; its batches are host numpy, and a network moves each
to its device when it trains on it.
"""

from __future__ import annotations

import os
import shutil
from typing import Iterator, List, Optional, Tuple

from ..datasets.dataset import DataSet
from ..datasets.iterators import DataSetIterator
from ..scaleout.data import load_dataset


class CloudStorage:
    """Storage SPI: URIs are ``<scheme>://<bucket>/<key>`` or local
    paths."""

    def upload(self, local_path: str, uri: str) -> str:
        raise NotImplementedError

    def download(self, uri: str, local_path: str) -> str:
        raise NotImplementedError

    def list(self, uri: str) -> List[str]:
        """Objects under a prefix, full URIs, sorted."""
        raise NotImplementedError

    def exists(self, uri: str) -> bool:
        raise NotImplementedError

    def delete(self, uri: str) -> None:
        raise NotImplementedError


class LocalFilesystemStorage(CloudStorage):
    """Local/file:// backend — the shared-filesystem deployment (every
    host of a cluster mounts the same NFS/GCS-fuse path), and the test
    backend (the reference tests S3 logic against local fixtures the
    same way)."""

    @staticmethod
    def _path(uri: str) -> str:
        return uri[len("file://"):] if uri.startswith("file://") else uri

    def upload(self, local_path: str, uri: str) -> str:
        dest = self._path(uri)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        shutil.copyfile(local_path, dest)
        return uri

    def download(self, uri: str, local_path: str) -> str:
        os.makedirs(os.path.dirname(local_path) or ".", exist_ok=True)
        shutil.copyfile(self._path(uri), local_path)
        return local_path

    def list(self, uri: str) -> List[str]:
        root = self._path(uri)
        if not os.path.isdir(root):
            return []
        out = []
        for dirpath, _, files in os.walk(root):
            for f in files:
                out.append(os.path.join(dirpath, f))
        prefix = "file://" if uri.startswith("file://") else ""
        return sorted(prefix + p for p in out)

    def exists(self, uri: str) -> bool:
        return os.path.exists(self._path(uri))

    def delete(self, uri: str) -> None:
        path = self._path(uri)
        if os.path.isfile(path):
            os.remove(path)


class _GatedStorage(CloudStorage):
    """Backend whose SDK is not installed."""

    def __init__(self, scheme: str, package: str):
        raise ImportError(
            f"{scheme}:// storage needs the '{package}' SDK, which is not "
            f"installed; use a shared filesystem mount "
            f"(LocalFilesystemStorage) or install {package} in your "
            f"deployment")


def get_storage(uri: str) -> CloudStorage:
    """Backend for a URI (reference: S3Uploader/S3Downloader selection).
    Unknown schemes are rejected, not treated as local paths."""
    if uri.startswith("gs://"):
        try:
            import google.cloud.storage  # noqa: F401
        except ImportError:
            _GatedStorage("gs", "google-cloud-storage")
        raise NotImplementedError("gcs backend: SDK present but backend "
                                  "not implemented in this build")
    if uri.startswith("s3://"):
        try:
            import boto3  # noqa: F401
        except ImportError:
            _GatedStorage("s3", "boto3")
        raise NotImplementedError("s3 backend: SDK present but backend "
                                  "not implemented in this build")
    scheme, sep, _ = uri.partition("://")
    if sep and scheme != "file":
        raise ValueError(f"unsupported storage scheme {scheme!r} in {uri!r}")
    return LocalFilesystemStorage()


class RemoteDataSetIterator(DataSetIterator):
    """Iterate exported ``.npz`` minibatches from a storage prefix
    (reference ``BaseS3DataSetIterator``), downloading each object
    through a local cache directory before parsing."""

    def __init__(self, uri_prefix: str,
                 storage: Optional[CloudStorage] = None,
                 cache_dir: Optional[str] = None):
        import tempfile
        self.storage = storage or get_storage(uri_prefix)
        self.uris = [u for u in self.storage.list(uri_prefix)
                     if u.endswith(".npz")]
        if not self.uris:
            raise ValueError(f"no .npz minibatches under {uri_prefix}")
        self.cache_dir = cache_dir or tempfile.mkdtemp(
            prefix="dl4jtpu_remote_")
        self._pos = 0

    def reset(self) -> None:
        self._pos = 0

    def batch(self) -> int:
        # peek the first object WITHOUT touching iteration state
        return load_dataset(self._fetch(self.uris[0])).num_examples()

    def _fetch(self, uri: str) -> str:
        # cache key from the full URI: same-named objects in different
        # prefixes must not collide
        import hashlib
        digest = hashlib.sha1(uri.encode("utf-8")).hexdigest()[:12]
        local = os.path.join(self.cache_dir,
                             f"{digest}_{os.path.basename(uri)}")
        if not os.path.exists(local):
            self.storage.download(uri, local)
        return local

    def __next__(self) -> DataSet:
        if self._pos >= len(self.uris):
            raise StopIteration
        uri = self.uris[self._pos]
        self._pos += 1
        return self._pre(load_dataset(self._fetch(uri)))
