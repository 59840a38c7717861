from segtpu_torch.metrics.metrics import (
    calculate_metrics,
    compute_foreground_ratio,
    iou_score,
    post_process,
)
from segtpu_torch.metrics.threshold import sweep_thresholds
