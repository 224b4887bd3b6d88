from rmcl_tpu_torch.math.se3 import EulerAngles, Quaternion, Transform  # noqa: F401
from rmcl_tpu_torch.math.gaussian import CrossStatistics, Gaussian1D  # noqa: F401
from rmcl_tpu_torch.math.stats import (  # noqa: F401
    gaussian_pdf, kabsch_rotation, markley_mean, pose_covariance_6x6, sample_pose_gaussian,
    sample_pose_uniform, umeyama_transform, weighted_pose_mean)
