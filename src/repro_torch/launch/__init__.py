# Entry points of the port's LM substrate.  serve.py is the serving loop
# (python -m repro_torch.launch.serve); nothing here touches a device at
# import time.
