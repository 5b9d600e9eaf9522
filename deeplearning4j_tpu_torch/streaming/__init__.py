"""Streaming online inference/training tier (port of
``deeplearning4j_tpu/streaming/``).

Equivalent of the reference's ``dl4j-streaming`` module
(Kafka + Camel + Spark Streaming:
``streaming/pipeline/spark/SparkStreamingPipeline.java``, record->array
converters under ``streaming/conversion/``): a micro-batching pipeline
that pulls records from a pluggable source, converts them to arrays, and
either serves predictions or trains online.

The Kafka/ZooKeeper/Camel transport stack is replaced by stdlib
transports (the pipeline contract — at-least-once micro-batches from an
unbounded source — is what the reference's tests check):

- :class:`InMemoryRecordSource` — bounded queue (the embedded-Kafka role
  the reference's tests play with ``EmbeddedKafkaCluster``).
- :class:`FileTailRecordSource` — follows a growing file of records
  (one JSON object or CSV row per line).
- :class:`SocketRecordSource` — listens on a TCP port for
  newline-delimited records.

See :mod:`.pipeline` for :class:`StreamingPipeline` and
:mod:`.conversion` for the record->array converter SPI.
"""

from .broker import (BrokerRecordSource, StreamBroker, StreamConsumer,
                     StreamProducer)
from .conversion import (CsvRecordConverter, DictRecordConverter,
                         RecordConverter)
from .pipeline import StreamingPipeline
from .sources import (FileTailRecordSource, InMemoryRecordSource,
                      RecordSource, SocketRecordSource)

__all__ = [
    "RecordConverter", "CsvRecordConverter", "DictRecordConverter",
    "StreamingPipeline", "RecordSource", "InMemoryRecordSource",
    "FileTailRecordSource", "SocketRecordSource", "StreamBroker",
    "StreamProducer", "StreamConsumer", "BrokerRecordSource",
]
