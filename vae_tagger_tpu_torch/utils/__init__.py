from .pipelining import OneInFlight
from .profiling import ThroughputMeter

__all__ = ["OneInFlight", "ThroughputMeter"]
