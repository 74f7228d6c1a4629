from istnet_tpu_torch.utils.config import Config
from istnet_tpu_torch.utils.logging import get_logger

__all__ = ["Config", "get_logger"]
