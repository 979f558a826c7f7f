"""Import-path shim: the reference's consistency and stability metrics
import ``quantile_map`` from ``segmentation.analysis.equivariance``, a
module absent from its repository; the function lives in
``analysis/common.py`` and is re-exported here under that path."""

from scaleprotoseg_torch.analysis.common import quantile_map  # noqa: F401
