# Entry points of the port's LM substrate.  serve.py is the serving loop
# (python -m repro_torch.launch.serve), train.py the training loop
# (python -m repro_torch.launch.train); nothing here touches a device at
# import time.
