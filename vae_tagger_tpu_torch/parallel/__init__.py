from .mesh import (
    auto_data_parallel,
    gather_to_host,
    initialize_distributed,
    is_main_process,
    process_count,
    process_index,
)

__all__ = [
    "auto_data_parallel",
    "gather_to_host",
    "initialize_distributed",
    "is_main_process",
    "process_count",
    "process_index",
]
