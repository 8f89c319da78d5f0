from repro_torch.optim.adamw import (
    AdamWConfig, QMoment, init_opt_state, abstract_opt_state,
    opt_logical_specs, apply_updates, global_norm,
)
from repro_torch.optim.schedules import ScheduleConfig, schedule_lr
