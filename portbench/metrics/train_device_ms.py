"""train_device_ms: local SGD's device time a replayed round, every lane at
once: the stamps at the start and end of ``fl.train`` inside the captured
round (``core/engine.py::build_round_phases``), read from the traced
calls' replays (``repro_torch.utils.spans``)."""
from portbench.program_spans import replay_ms


def read(run):
    if run.trace is None:
        return None
    return replay_ms("fl.train")
