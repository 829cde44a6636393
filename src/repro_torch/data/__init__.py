from repro_torch.data import friedman, lm, partition, sources
from repro_torch.data.partition import PARTITIONS, register_partition
from repro_torch.data.sources import SOURCES, register_source

__all__ = ["friedman", "lm", "partition", "sources",
           "SOURCES", "register_source", "PARTITIONS", "register_partition"]
