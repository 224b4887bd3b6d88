from rmcl_tpu_torch.math.se3 import EulerAngles, Quaternion, Transform  # noqa: F401
from rmcl_tpu_torch.math.gaussian import CrossStatistics, Gaussian1D  # noqa: F401
from rmcl_tpu_torch.math.stats import kabsch_rotation, umeyama_transform  # noqa: F401
