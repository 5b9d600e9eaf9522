"""Cloud storage and cluster provisioning (port of
``deeplearning4j_tpu/cloud``), the equivalent of the reference's
``deeplearning4j-aws`` module (``S3Uploader``, ``S3Downloader`` +
``BaseS3DataSetIterator``, ``ClusterSetup``/``HostProvisioner``):

- :class:`CloudStorage`, the storage SPI, with a local-filesystem backend
  (always available) and gcs/s3 backends gated on their SDKs;
- :class:`RemoteDataSetIterator`, which streams exported ``.npz``
  minibatches from a storage URI through a bounded local cache;
- :class:`TpuPodProvisioner`, which emits the per-host launch scripts and
  environment of an N-host cluster (the coordinator address, process ids
  and count the port's ``parallel.mesh`` reads).

Nothing here touches a device: the batches are host numpy, and the
launched command picks its own device.
"""

from .provision import TpuPodProvisioner
from .storage import (CloudStorage, LocalFilesystemStorage,
                      RemoteDataSetIterator, get_storage)

__all__ = [
    "CloudStorage", "LocalFilesystemStorage", "RemoteDataSetIterator",
    "get_storage", "TpuPodProvisioner",
]
