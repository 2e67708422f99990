from modern_search_engines_project_tpu_torch.utils.timing import (
    StageTimes,
    device_trace,
    stage_timer,
)

__all__ = ["StageTimes", "device_trace", "stage_timer"]
