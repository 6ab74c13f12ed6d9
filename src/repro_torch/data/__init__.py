"""Data pipelines: ``TokenStream``, synthetic LM batches, and
``ChannelStream``, the paper's transmitter and channel (Fig. 12), both
deterministic, shardable batch sources."""
from .pipeline import ChannelStream, TokenStream  # noqa: F401
