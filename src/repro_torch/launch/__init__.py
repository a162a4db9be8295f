"""The port's command-line entry points: ``python -m
repro_torch.launch.fl_sim`` (the FL experiment), ``repro_torch.launch.
train`` (LM training) and ``repro_torch.launch.serve`` (LM generation).
Each runs on the card unless ``--device cpu`` asks for the CPU.
``repro_torch.launch.fl_round.fl_round_step`` is the paper's round over
whole LM clients, on the device its clients lie on."""
