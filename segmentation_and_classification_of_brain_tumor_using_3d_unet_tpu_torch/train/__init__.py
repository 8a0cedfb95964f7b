from .checkpoints import (restore_checkpoint,  # noqa: F401
                          restore_params_only, save_checkpoint,
                          save_params_only)
from .loop import (make_eval_step, make_joint_train_step,  # noqa: F401
                   make_loss_fn, make_train_step)
from .state import (Optimizer, TrainState, build_optimizer,  # noqa: F401
                    cosine_warm_restarts, create_train_state, current_lr,
                    ema_eval_state)
from .trainer import ModernBrainTumorTrainer  # noqa: F401
