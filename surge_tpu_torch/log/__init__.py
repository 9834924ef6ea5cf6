"""The log substrate — the port's copy of the parts of ``surge_tpu/log`` an
engine over the in-memory log reaches: the transport contract, the in-memory
log (with :func:`copy_log`), the compactor and the columnar segments. The
file-backed log and the gRPC transports are not ported."""

from surge_tpu_torch.log.compactor import CompactionStats, LogCompactor
from surge_tpu_torch.log.memory import InMemoryLog, copy_log
from surge_tpu_torch.log.transport import (
    LogRecord,
    LogTransport,
    NotLeaderError,
    ProducerFencedError,
    TopicSpec,
    TransactionalProducer,
    TransactionStateError,
    page_keyed_records,
)

__all__ = ["CompactionStats", "InMemoryLog", "LogCompactor", "LogRecord",
           "LogTransport", "NotLeaderError", "ProducerFencedError", "TopicSpec",
           "TransactionStateError", "TransactionalProducer", "copy_log",
           "page_keyed_records"]
