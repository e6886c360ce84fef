"""Evaluation metrics, five families (the JAX package's ``metrics/``), on
the masks' device; the contours of the contour family on the host.

Family -> reference module (``Metrics/``):
- confusion   -> ``ConfusionMatrix_based_metrics.py``
- region      -> ``Region_based_metrics.py``
- contour     -> ``Contour_based_metrics.py``
- pixel_error -> ``PixelError_based_metrics.py``
- biomarker   -> ``Biomarker_based_metrics.py``

``volume.py`` scores whole label volumes for ``Trainer.evaluate``.
"""

from .confusion import (  # noqa: F401
    accuracy,
    auc_score,
    confusion_counts,
    precision as cm_precision,
    sensitivity,
    specificity,
)
from .region import (  # noqa: F401
    dice_coefficient,
    iou_score,
    precision,
    recall,
)
from .contour import (  # noqa: F401
    assd,
    find_contours,
    hausdorff_distance,
    hausdorff_distance_95,
    mad,
    surface_distances,
)
from .pixel_error import (  # noqa: F401
    mean_squared_error,
    root_mean_squared_error,
)
from .biomarker import (  # noqa: F401
    thickness_difference,
    vascularity_index,
)
