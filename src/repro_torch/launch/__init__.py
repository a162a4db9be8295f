"""The port's command-line entry points: ``python -m
repro_torch.launch.fl_sim`` (the FL experiment), ``repro_torch.launch.
train`` (LM training) and ``repro_torch.launch.serve`` (LM generation).
Each runs on the card unless ``--device cpu`` asks for the CPU."""
