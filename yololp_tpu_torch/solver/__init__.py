from yololp_tpu_torch.solver.build import (
    SolverConfig,
    accumulate_steps,
    ema_decay,
    ema_update,
    init_momentum,
    label_groups,
    label_tree,
    lr_lambda,
    param_group_label,
    schedule,
    sgd_apply,
    warmup_steps,
)
