"""The port's logger (the counterpart of ``nellie_tpu/utils/base_logger.py``):
a module-level ``logger`` named ``nellie_tpu_torch``, with file:lineno
formatting at INFO level."""
import logging

logging.basicConfig(
    level=logging.INFO,
    format="%(asctime)s - %(levelname)s - %(filename)s:%(lineno)s - %(message)s",
)

logger = logging.getLogger("nellie_tpu_torch")
logger.setLevel(logging.INFO)
