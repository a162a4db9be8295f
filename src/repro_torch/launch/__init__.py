"""The port's command-line entry points: ``python -m
repro_torch.launch.fl_sim`` (the FL experiment), ``repro_torch.launch.
train`` (LM training), ``repro_torch.launch.serve`` (LM generation) and
``repro_torch.launch.dryrun`` (every arch × shape laid out on the
production meshes on ``meta`` and counted against the H100's roofline).
Each runs on the card unless ``--device cpu`` asks for the CPU (the dry
run touches no device). ``repro_torch.launch.fl_round.fl_round_step`` is
the paper's round over whole LM clients, on the device its clients lie
on; ``lower_fl_round`` lays it out on a mesh. ``mesh`` and ``shapes``
are the meshes, the H100's peaks and the ``meta`` stand-ins."""
