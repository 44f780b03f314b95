from repro_torch.train.loop import TrainConfig, TrainLoop, make_train_step  # noqa: F401
