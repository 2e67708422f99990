from modern_search_engines_project_tpu_torch.utils.timing import (
    GLOBAL_TIMES,
    StageTimes,
    device_trace,
    stage_timer,
)

__all__ = ["GLOBAL_TIMES", "StageTimes", "device_trace", "stage_timer"]
