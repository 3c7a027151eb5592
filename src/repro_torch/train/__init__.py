from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step
