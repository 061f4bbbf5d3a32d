"""Entry points: ``python -m repro_torch.launch.train`` trains on one
device (``launch.train.run``)."""
