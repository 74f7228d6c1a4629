from istnet_tpu_torch.utils.config import Config
from istnet_tpu_torch.utils.io import write_obj
from istnet_tpu_torch.utils.logging import get_logger
from istnet_tpu_torch.utils.profiling import timed, trace

__all__ = ["Config", "get_logger", "timed", "trace", "write_obj"]
