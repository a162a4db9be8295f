"""sao_solve_ms: ``repro_torch.core.sao.solve_sao`` alone at the arrays of
the last traced round's selected devices (the lanes stacked in a
cohort), CUDA events over ten calls of its captured graph."""


def read(run):
    return getattr(run.cell, "sao_solve_ms", None)
