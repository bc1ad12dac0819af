from kafkabalancer_tpu_torch.codecs.readers import (
    CodecError,
    get_partition_list_from_reader,
)
from kafkabalancer_tpu_torch.codecs.writer import (
    filter_partition_list,
    write_partition_list,
)
from kafkabalancer_tpu_torch.codecs.zookeeper import (
    get_partition_list_from_zookeeper,
    parse_zk_connection_string,
)

__all__ = [
    "CodecError",
    "filter_partition_list",
    "get_partition_list_from_reader",
    "get_partition_list_from_zookeeper",
    "parse_zk_connection_string",
    "write_partition_list",
]
