from .pipelining import OneInFlight
from .profiling import ThroughputMeter, trace
from .synthetic import create_synthetic_dataset

__all__ = ["OneInFlight", "ThroughputMeter", "create_synthetic_dataset",
           "trace"]
