from speedy_ml_tpu_torch.core.constants import PhysicalConstants
from speedy_ml_tpu_torch.core.geometry import Geometry

__all__ = ["PhysicalConstants", "Geometry"]
