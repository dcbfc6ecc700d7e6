from .config import PipelineConfig
from .logger import get_logger
from .metrics import MetricsTracker
from .platform import PlatformUtils

__all__ = ["PipelineConfig", "get_logger", "MetricsTracker", "PlatformUtils"]
