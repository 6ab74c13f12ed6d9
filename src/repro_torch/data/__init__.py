"""Data pipelines: ``ChannelStream``, the paper's transmitter and channel
(Fig. 12) as a deterministic, shardable batch source."""
from .pipeline import ChannelStream  # noqa: F401
