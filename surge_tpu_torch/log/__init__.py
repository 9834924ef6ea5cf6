"""The log substrate the resident state plane reads — a copy of the parts of
``surge_tpu/log`` it and ``chip_smoke.py`` use."""

from surge_tpu_torch.log.memory import InMemoryLog
from surge_tpu_torch.log.transport import LogRecord, TopicSpec, page_keyed_records

__all__ = ["InMemoryLog", "LogRecord", "TopicSpec", "page_keyed_records"]
