from repro_torch.utils.logging import get_logger
from repro_torch.utils.timing import Timer

__all__ = ["get_logger", "Timer"]
